"""Training-side modules. Only what the SUN-D eval needs is ported so far
(``meta_tune_emd.make_patch_fn`` / ``make_emd_episode_fn`` for eval)."""

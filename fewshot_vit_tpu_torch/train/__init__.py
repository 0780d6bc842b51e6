"""The trainers: phase 3a ``meta_tune`` (SUN-M) and phase 3b ``meta_tune_emd``
(SUN-D), with the optimizer recipes, train state, step and epoch programs
they share. Phase 1 (``pretrain``) and phase 2 (``sun``) are not ported yet."""

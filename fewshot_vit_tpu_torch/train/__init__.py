"""The trainers: phase 1 ``pretrain`` (teacher CE), phase 2 ``sun`` (SUN
meta-training from a frozen teacher), phase 3a ``meta_tune`` (SUN-M) and
phase 3b ``meta_tune_emd`` (SUN-D), with the optimizer recipes, SAM, train
state, step and epoch programs they share."""

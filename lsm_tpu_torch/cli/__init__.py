"""The port's stage entry points, run as `python -m lsm_tpu_torch.cli.<name>`:
create_dataset, extract_lsm_features, train_classifier and classify (the
counterparts of the repo-root scripts of the same names)."""

"""The port's entry points, run as `python -m lsm_tpu_torch.cli.<name>`:
create_dataset, extract_lsm_features, train_classifier, classify and
stream_kws (the counterparts of the repo-root scripts of the same names)."""

"""Measurement and operator tools of the port, run as `python -m lsm_tpu_torch.tools.<name>`."""

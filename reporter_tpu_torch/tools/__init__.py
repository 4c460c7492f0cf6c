"""Operator tools of the port: the fleet supervisor (``python -m
reporter_tpu_torch.tools.fleet``)."""

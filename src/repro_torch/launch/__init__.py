"""Entry points of the port: ``python -m repro_torch.launch.serve``, and
the routing mesh of the sharded route step (``launch.mesh``)."""

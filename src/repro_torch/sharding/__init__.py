"""Sharding of the port: logical activation constraints (``act``) and the
parameter, batch and decode-state layouts (``specs``) over a
``torch.distributed`` ``DeviceMesh``."""

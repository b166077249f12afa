"""Launch layer of the port: the serving, decode-step and federated
training drivers, and the rank meshes and worlds of the multi-device
paths (``mesh``, ``world``)."""

"""Distributed rendering over torch.distributed (port of
mitsuba_tpu/parallel/): the sharded render of every integrator family
(mesh.py), the elastic pass loop (elastic.py), the persistent render
service (service.py) and multi-host start-up (multihost.py).

Nothing here starts a process, opens a socket or joins a process group
when it is imported."""

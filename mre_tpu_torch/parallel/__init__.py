"""The parallel layer (port of mre_tpu/parallel): the ``(data, model)``
process mesh, its sharding rules and collectives (``mesh.py``)."""

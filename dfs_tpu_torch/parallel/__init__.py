"""Multi-device execution: the device mesh (``mesh``) and the sharded
anchored and aligned steps (``sharded_cdc``)."""

"""Multi-device execution: the device mesh (``mesh``), the sharded
anchored, aligned and rolling steps (``sharded_cdc``), and one sharded
program across processes (``multihost``)."""

from dfs_tpu_torch.comm.wire import read_msg, send_msg  # noqa: F401

"""The chunk+hash sidecar (:mod:`dfs_tpu_torch.sidecar.service`) and the
HTTP/2 and HPACK code it speaks gRPC with."""

from dfs_tpu_torch.sidecar.service import (SidecarClient,  # noqa: F401
                                           SidecarError, SidecarFragmenter,
                                           SidecarServer)

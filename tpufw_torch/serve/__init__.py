"""Serving wire formats (port of ``tpufw.serve``): the TPFB page bundle
that carries KV pages between a pool and the spill tier. The
disaggregated roles, the router and the transport are ROADMAP.md Queue 1
item 9 and are not imported here."""

from tpufw_torch.serve.bundle import (  # noqa: F401
    BundleError,
    decode_bundle,
    encode_bundle,
)

"""Serving forwards: BN folded into producer convolutions with heads pruned
(`serve.py`), the int8-activation graph over the `ops/conv_i8.py` kernel
(`serve_q.py`), and the fused trunk in hand-written kernels
(`trunk_kernel.build_trunk_fn`, `trunk_kernel2.build_trunk_fn_v2`), swapped
into the model through `P3achyGoModel.forward(..., trunk_fn=...)`."""
from p3achygo_tpu_torch.nn.serve import ServeNet, serve_supported
from p3achygo_tpu_torch.nn.serve_q import ServeQNet, calibrate, q_supported, serve_q_forward
from p3achygo_tpu_torch.nn.trunk_kernel import build_trunk_fn, trunk_supported
from p3achygo_tpu_torch.nn.trunk_kernel2 import build_trunk_fn_v2

__all__ = ["ServeNet", "ServeQNet", "build_trunk_fn", "build_trunk_fn_v2", "calibrate",
           "q_supported", "serve_q_forward", "serve_supported", "trunk_supported"]

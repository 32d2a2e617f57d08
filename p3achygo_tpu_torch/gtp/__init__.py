"""GTP front end (port of p3achygo_tpu/gtp)."""
from p3achygo_tpu_torch.gtp.service import (  # noqa: F401
    GtpConfig,
    GtpService,
    action_to_gtp_vertex,
    gtp_vertex_to_action,
    run_stdin_loop,
)

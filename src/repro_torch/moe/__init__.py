"""MoE with Consistent-Grouping routing (the paper's technique on the
expert axis; port of ``repro.moe``)."""
from .layer import MoEFFN, init_moe_params, moe_ffn  # noqa: F401
from .router import RoutingResult, route  # noqa: F401

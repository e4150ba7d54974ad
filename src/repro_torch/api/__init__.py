"""``repro_torch.api`` — the endpoint-driven front door (DESIGN.md §5).

Counterpart of ``repro/api``.  One declarative :class:`SessionSpec`
describes the fabric, the tenant, the adaptivity level
(``static | adaptive | arbitrated``) and the device the runtime solves on;
one :class:`Session` owns construction, binding order, teardown, and hands
out ready-wired endpoints (``all_to_all``, ``moe_dispatcher``, ``plan``,
``step``/``run_trace``, ``report``).  Session-built stacks are
bit-identical to the hand-wired constructors they replace — which keep
working unchanged.

    from repro_torch.api import Session, SessionSpec, TopologySpec

    spec = SessionSpec(topology=TopologySpec(8, group_size=4),
                       adaptivity="adaptive")          # device="cuda"
    with Session(spec) as sess:
        comm = sess.all_to_all(max_chunks=32, chunk_bytes=2**20)
        result = sess.run_trace(trace)
        record = sess.report()

``python -m repro_torch.api.selfcheck [--device cpu]`` verifies the
facade's guarantees in the current environment.
"""

from .session import PLAN_MODES, Session
from .spec import (
    ADAPTIVITY_LEVELS,
    FABRIC_STALENESS_DEFAULT,
    PRICE_DECAY_DEFAULT,
    SessionSpec,
    TopologySpec,
)

__all__ = [
    "ADAPTIVITY_LEVELS",
    "FABRIC_STALENESS_DEFAULT",
    "PRICE_DECAY_DEFAULT",
    "PLAN_MODES",
    "Session",
    "SessionSpec",
    "TopologySpec",
    "validate_fairness_record",
]


def __getattr__(name: str):
    # lazy: importing .selfcheck from here would shadow
    # ``python -m repro_torch.api.selfcheck`` (runpy double-import warning)
    if name == "validate_fairness_record":
        from .selfcheck import validate_fairness_record

        return validate_fairness_record
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

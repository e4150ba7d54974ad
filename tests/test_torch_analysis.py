"""The port's static checker (``repro_torch.analysis``) against the reference's.

* **Parity.**  Every case of ``tests/test_analysis.py`` and
  ``tests/test_interproc.py`` that does not test JAX tracing (all but
  ``jit-purity``'s three and the ``retrace`` ones) runs through both
  checkers: its fixture at ``repro/...`` through ``repro.analysis`` and at
  ``repro_torch/...`` through ``repro_torch.analysis``.  Findings must be
  equal in rule id, path, line, column and message (``repro_torch`` read as
  ``repro``), and so must every other result a case returns.
* **Injected violations.**  An unseeded ``torch.randn`` under
  ``repro_torch/core/`` is a ``determinism`` finding; an ``.item()`` in a
  function that ``train_step`` reaches is a ``host-sync`` finding when
  PLAN_DEPENDENT and an inventory entry otherwise; the same read in
  ``launch/`` gives nothing.
* **The shipped tree** (``src/repro_torch`` linted once for the module):
  clean with the shipped baseline, whose every entry is a ``host-sync``
  debt naming the ROADMAP Queue 2 item that retires it; both locks fresh
  and line-free; the inventory holds the sites the card's sync audit
  records (``launch/sync_audit.py``), and the audit matches each sync
  warning to its traced sync at its site.
"""

import importlib
import json
import os
import types

import pytest

pytestmark = pytest.mark.torch_port

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
PORT_SRC = os.path.join(SRC, "repro_torch")


def _pkg(name: str):
    """The modules of one checker, and how a fixture is spelled for it."""
    m = {k: importlib.import_module(f"{name}.analysis{'.' + k if k else ''}")
         for k in ("", "engine", "rules", "callgraph", "provenance", "__main__")}
    return types.SimpleNamespace(
        name=name, a=m[""], engine=m["engine"], rules=m["rules"],
        callgraph=m["callgraph"], provenance=m["provenance"], main=m["__main__"],
        jsonio=importlib.import_module(f"{name}.jsonio"),
        path=lambda p: p.replace("repro/", f"{name}/", 1),
        src=lambda s: s.replace("from repro.", f"from {name}."),
    )


REF, PORT = _pkg("repro"), _pkg("repro_torch")


def _norm(obj):
    """``repro_torch`` read as ``repro``, through containers."""
    if isinstance(obj, str):
        return obj.replace("repro_torch", "repro")
    if isinstance(obj, (list, tuple)):
        return [_norm(x) for x in obj]
    if isinstance(obj, dict):
        return {_norm(k): _norm(v) for k, v in obj.items()}
    return obj


def _findings(report):
    return {
        "findings": [(f.rule, f.path, f.line, f.col, f.message) for f in report.findings],
        "suppressed": [(f.rule, f.line) for f in report.suppressed],
        "baselined": [(f.rule, f.line) for f in report.baselined],
    }


# -- the reference's fixtures (tests/test_analysis.py, tests/test_interproc.py) ---

DET_POSITIVE = '''
import time
import random
import numpy as np

def schedule(tenants):
    t0 = time.time()
    jitter = random.random()
    noise = np.random.rand()
    for t in {x for x in tenants}:     # hash-order iteration
        pass
    order = list(set(tenants))         # hash-order materialization
    return t0 + jitter + noise
'''

DET_NEGATIVE = '''
import numpy as np

def schedule(tenants, seed):
    rng = np.random.default_rng(seed)
    jitter = rng.random()
    for t in sorted(set(tenants)):     # sorted: order is stable
        pass
    return jitter
'''

SCHEMA_POSITIVE = '''
from repro.jsonio import tag

BAD_LITERAL = "nimble.Sim-Result/v1"       # kind fails the spelling rule
NO_VERSION = "nimble.simresult/vNext"      # non-integer version

def emit(r):
    return tag("not_a_known_kind", {"x": 1})

def emit2(r):
    return tag("simresult", {"completion_time_s": 1.0, "surprise_key": 2})
'''

SCHEMA_NEGATIVE = '''
from repro.jsonio import tag

def emit(r):
    return tag("simresult", {"completion_time_s": r.t})
'''

FROZEN_POSITIVE = '''
import dataclasses

@dataclasses.dataclass(frozen=True)
class Spec:
    weights: list = []                 # mutable default, shared

def patch(spec):
    object.__setattr__(spec, "weights", [1])   # outside __post_init__
'''

FROZEN_NEGATIVE = '''
import dataclasses

@dataclasses.dataclass(frozen=True)
class Spec:
    weights: tuple = ()
    total: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "total", sum(self.weights))
'''

FLOAT_NAN = '''
import math
import numpy as np

def probe(x):
    return x == np.nan or x != math.nan or x == float("nan")
'''

FLOAT_ISNAN = '''
import numpy as np

def probe(x):
    return np.isnan(x) or x >= 0.25
'''

SUPPRESSED = '''
import time

def schedule(tenants):
    return time.time()  # nimble: ignore[determinism] -- wall clock feeds a log label only
'''

ALPHA = '''
def helper(x):
    return x + 1

def outer(x):
    return helper(x)
'''

BETA = '''
from .alpha import outer as entry

def run(x):
    return entry(x)
'''

UNITS_POSITIVE = '''
def admit(payload_bytes, alpha_frac):
    return payload_bytes + alpha_frac
'''

UNITS_NEGATIVE = '''
def admit(payload_bytes, alpha_frac, total_bytes):
    scaled = payload_bytes * alpha_frac      # fraction scales freely
    share = payload_bytes / total_bytes      # bytes/bytes -> fraction
    return scaled, share + alpha_frac        # fraction + fraction
'''

SENDER_MOD = '''
def send(payload_bytes):
    return payload_bytes
'''

CALLER_MIX = '''
from .sender import send

def relay(alpha_frac):
    return send(alpha_frac)
'''

CALLER_OK = '''
from .sender import send

def relay(chunk_bytes):
    return send(chunk_bytes)
'''

LIVE_SET_MOD = '''
def live_nodes(xs):
    return set(xs)
'''

LIVE_WRAP_MOD = '''
from .live import live_nodes

def active(xs):
    return live_nodes(xs)
'''

CONSUMER_BAD = '''
from ..fabric.wrap import active

def commit_order(xs):
    return [n for n in active(xs)]
'''

CONSUMER_OK = '''
from ..fabric.wrap import active

def commit_order(xs):
    return sorted(active(xs))
'''


def _fixture_lock():
    return {"kinds": {"simresult": {
        "version": 1, "keys": ["completion_time_s", "total_payload_bytes"], "sites": 1}}}


def _lint(P, src, path="<fixture>.py", rules=None):
    return _findings(P.a.analyze_source(P.src(src), path=P.path(path), rules=rules))


def _lint_many(P, files, rules):
    return _findings(P.a.analyze_sources([(P.path(p), P.src(s)) for p, s in files],
                                         rules=rules))


def _contexts(P, files):
    return [P.a.build_context(P.path(p), P.src(s), P.path(p).rsplit("/", 1)[0].replace("/", "."))
            for p, s in files]


# -- the parity cases: each returns what both checkers must agree on --------------

def case_determinism_positive(P):
    return _lint(P, DET_POSITIVE, "repro/core/fixture.py", [P.rules.DeterminismRule()])


def case_determinism_negative(P):
    return _lint(P, DET_NEGATIVE, "repro/fabric/fixture.py", [P.rules.DeterminismRule()])


def case_determinism_scope_is_path_based(P):
    return _lint(P, DET_POSITIVE, "repro/runtime/fixture.py", [P.rules.DeterminismRule()])


def case_schema_discipline_positive(P):
    return _lint(P, SCHEMA_POSITIVE, rules=[P.rules.SchemaDisciplineRule(lock=_fixture_lock())])


def case_schema_discipline_negative(P):
    return _lint(P, SCHEMA_NEGATIVE, rules=[P.rules.SchemaDisciplineRule(lock=_fixture_lock())])


def case_schema_discipline_version_mismatch(P):
    return _lint(P, 'REF = "nimble.simresult/v9"\n',
                 rules=[P.rules.SchemaDisciplineRule(lock=_fixture_lock())])


def case_frozen_spec_positive(P):
    return _lint(P, FROZEN_POSITIVE, rules=[P.rules.FrozenSpecRule()])


def case_frozen_spec_negative(P):
    return _lint(P, FROZEN_NEGATIVE, rules=[P.rules.FrozenSpecRule()])


def case_float_eq_nan_flagged_everywhere(P):
    return _lint(P, FLOAT_NAN, rules=[P.rules.FloatEqRule()])


def case_float_eq_literal_in_sentinel_path(P):
    return _lint(P, "def f(x):\n    return x == 0.25\n", "repro/runtime/telemetry.py",
                 [P.rules.FloatEqRule()])


def case_float_eq_literal_outside_sentinel_paths(P):
    return _lint(P, "def f(x):\n    return x == 0.25\n", "repro/core/fixture.py",
                 [P.rules.FloatEqRule()])


def case_float_eq_isnan_is_fine(P):
    return _lint(P, FLOAT_ISNAN, "repro/runtime/estimator.py", [P.rules.FloatEqRule()])


def case_suppression_reclassifies_finding(P):
    return _lint(P, SUPPRESSED, "repro/core/fixture.py", [P.rules.DeterminismRule()])


def case_suppression_on_line_above(P):
    src = ("import time\ndef f():\n    # nimble: ignore[determinism] -- label only\n"
           "    return time.time()\n")
    return _lint(P, src, "repro/core/fixture.py", [P.rules.DeterminismRule()])


def case_suppression_without_reason_is_a_finding(P):
    src = SUPPRESSED.replace(" -- wall clock feeds a log label only", "")
    return _lint(P, src, "repro/core/fixture.py", [P.rules.DeterminismRule()])


def case_stale_suppression_is_a_finding(P):
    return _lint(P, "x = 1  # nimble: ignore[determinism] -- nothing here to suppress\n",
                 rules=[P.rules.DeterminismRule()])


def case_unknown_suppression_is_a_finding(P):
    return _lint(P, "x = 1  # nimble: ignore[made-up-rule] -- whatever\n",
                 rules=[P.rules.DeterminismRule()])


def case_parse_suppressions_shapes(P):
    (s,) = P.engine.parse_suppressions(
        "a = 1  # nimble: ignore[jit-purity, float-eq] -- two at once\n")
    return [s.line, list(s.rules), s.reason]


def case_baseline_roundtrip_and_line_churn(P, tmp_path):
    report = P.a.analyze_source(P.src(DET_POSITIVE), path=P.path("repro/core/fixture.py"),
                                rules=[P.rules.DeterminismRule()])
    path = str(tmp_path / "baseline.json")
    P.engine.write_baseline(report.findings, path)
    schema = json.loads(open(path).read())["schema"]
    baseline = P.a.load_baseline(path)
    for entry in baseline:
        entry["reason"] = "grandfathered fixture debt"
    churned = "# a new leading comment line\n" + DET_POSITIVE
    engine = P.a.AnalysisEngine([P.rules.DeterminismRule()], baseline)
    rerun = engine.run([P.a.build_context(P.path("repro/core/fixture.py"), churned,
                                          P.path("repro/core").replace("/", "."))])
    return [schema, _findings(report), _findings(rerun)]


def case_baseline_grows_loudly(P, tmp_path):
    report = P.a.analyze_source(P.src(DET_POSITIVE), path=P.path("repro/core/fixture.py"),
                                rules=[P.rules.DeterminismRule()])
    path = str(tmp_path / "baseline.json")
    P.engine.write_baseline(report.findings, path)
    engine = P.a.AnalysisEngine([P.rules.DeterminismRule()], P.a.load_baseline(path))
    rerun = engine.run([P.a.build_context(P.path("repro/core/fixture.py"), DET_POSITIVE,
                                          P.path("repro/core").replace("/", "."))])
    justified = P.a.load_baseline(path)
    for entry in justified:
        entry["reason"] = "known debt"
    with open(path, "w") as f:
        json.dump(P.engine.tag("lint_baseline", {"entries": justified}), f)
    P.engine.write_baseline(report.findings, path)
    return [_findings(rerun), [e["reason"] for e in P.a.load_baseline(path)]]


def case_stale_baseline_entry_is_a_finding(P):
    baseline = [{"rule": "determinism", "path": P.path("repro/core/fixture.py"),
                 "message": "no longer emitted", "reason": "was real once",
                 "since": "2026-01-01"}]
    engine = P.a.AnalysisEngine([P.rules.DeterminismRule()], baseline)
    return _findings(engine.run([P.a.build_context(
        P.path("repro/core/fixture.py"), "def f(xs):\n    return sorted(xs)\n",
        P.path("repro/core").replace("/", "."))]))


def case_missing_baseline_is_empty(P):
    return P.a.load_baseline("/nonexistent/baseline.json")


def case_report_carries_lint_v1_envelope(P):
    obj = P.a.analyze_source(P.src(DET_POSITIVE), path=P.path("repro/core/fixture.py")
                             ).to_json_obj()
    return [P.jsonio.parse_schema_id(obj["schema"]), obj]


def case_jsonio_strict_schema_ids(P):
    out = [P.jsonio.parse_schema_id("nimble.lint/v1")]
    for bad in ("lint/v1", "nimble.lint", "nimble.Lint/v1", "nimble.lint/1",
                "nimble.lint/v0", "nimble.lint/vX", "nimble./v1"):
        with pytest.raises(ValueError) as e:
            P.jsonio.parse_schema_id(bad)
        out.append(str(e.value))
    for kind, version in (("Not-A-Kind", 1), ("lint", 0), ("lint", 2)):
        with pytest.raises(ValueError) as e:
            P.jsonio.tag(kind, {}, version=version)
        out.append(str(e.value))
    out.append(P.jsonio.tag("brand_new_kind", {"x": 1}))
    return out


def case_injected_violation_is_caught(P):
    return _lint(P, "import time\nT0 = time.time()\n", "repro/fabric/fixture.py")


def case_debt_ledger_lists_suppressions_and_baseline(P):
    src = ("import time\n"
           "T0 = time.time()  # nimble: ignore[determinism] -- boot stamp\n")
    ctx = P.a.build_context(P.path("repro/core/fixture.py"), src,
                            P.path("repro/core").replace("/", "."))
    baseline = [{"rule": "float-eq", "path": P.path("repro/core/other.py"), "message": "m",
                 "reason": "legacy", "since": "2026-08-01"}]
    return P.a.collect_debt([ctx], baseline)


def case_debt_cli_report_envelope(P):
    obj = P.jsonio.tag(P.main.DEBT_KIND, {"suppressions": [], "baseline": [], "total": 0})
    return P.jsonio.parse_schema_id(obj["schema"])


def case_call_graph_golden_fixture(P):
    program = P.a.build_program(_contexts(P, [("repro/core/alpha.py", ALPHA),
                                              ("repro/core/beta.py", BETA)]))
    obj = program.call_graph().to_json_obj()
    graph = program.call_graph()
    return [obj, graph.callers(P.name + ".core.alpha.outer"), graph.n_edges]


def case_module_name_and_digest(P):
    cg = P.callgraph
    return [cg.module_name_of(P.path("repro/core/cost.py")),
            cg.module_name_of(P.path("repro/fabric/__init__.py")),
            cg.source_digest("a = 1\n") == cg.source_digest("a = 1\n"),
            cg.source_digest("a = 1\n") != cg.source_digest("a = 2\n")]


def case_function_summary_roundtrip(P):
    (ctx,) = _contexts(P, [("repro/core/alpha.py", ALPHA)])
    out = []
    for summary in P.callgraph.summarize_module(ctx):
        assert P.callgraph.FunctionSummary.from_json_obj(summary.to_json_obj()) == summary
        out.append(summary.to_json_obj())
    return out


def case_summary_cache_invalidation_on_edit(P, tmp_path):
    path = str(tmp_path / "summaries.cache.json")
    files = [("repro/core/alpha.py", ALPHA), ("repro/core/beta.py", BETA)]
    cold = P.a.SummaryCache(path)
    P.a.build_program(_contexts(P, files), cache=cold)
    cold.save()
    warm = P.a.SummaryCache(path)
    P.a.build_program(_contexts(P, files), cache=warm)
    partial = P.a.SummaryCache(path)
    program = P.a.build_program(_contexts(P, [("repro/core/alpha.py", ALPHA + "\nZ = 1\n"),
                                              files[1]]), cache=partial)
    return [(cold.hits, cold.misses), (warm.hits, warm.misses),
            (partial.hits, partial.misses),
            program.call_graph().edges[P.name + ".core.beta.run"]]


def case_lattice_join_order(P):
    pv = P.provenance
    return [pv.join(pv.TOPOLOGY_STABLE, pv.WINDOW_DEPENDENT),
            pv.join(pv.WINDOW_DEPENDENT, pv.PLAN_DEPENDENT),
            pv.join(pv.PLAN_DEPENDENT, pv.TOPOLOGY_STABLE)]


def case_units_mixing_in_one_function(P):
    return _lint_many(P, [("repro/core/ufix.py", UNITS_POSITIVE)], [P.rules.UnitsRule()])


def case_units_fraction_algebra_is_clean(P):
    return _lint_many(P, [("repro/core/ufix.py", UNITS_NEGATIVE)], [P.rules.UnitsRule()])


def case_units_cross_module_signature_mismatch(P):
    return _lint_many(P, [("repro/fabric/sender.py", SENDER_MOD),
                          ("repro/fabric/caller.py", CALLER_MIX)], [P.rules.UnitsRule()])


def case_units_cross_module_matching_units_clean(P):
    return _lint_many(P, [("repro/fabric/sender.py", SENDER_MOD),
                          ("repro/fabric/caller.py", CALLER_OK)], [P.rules.UnitsRule()])


def case_xmodule_hash_order_consumption_is_caught(P):
    return _lint_many(P, [("repro/fabric/live.py", LIVE_SET_MOD),
                          ("repro/fabric/wrap.py", LIVE_WRAP_MOD),
                          ("repro/core/sched.py", CONSUMER_BAD)],
                      [P.rules.CrossModuleDeterminismRule()])


def case_xmodule_sorted_consumption_is_clean(P):
    return _lint_many(P, [("repro/fabric/live.py", LIVE_SET_MOD),
                          ("repro/fabric/wrap.py", LIVE_WRAP_MOD),
                          ("repro/core/sched.py", CONSUMER_OK)],
                      [P.rules.CrossModuleDeterminismRule()])


def case_xmodule_scope_is_path_based(P):
    return _lint_many(P, [("repro/fabric/live.py", LIVE_SET_MOD),
                          ("repro/fabric/wrap.py", LIVE_WRAP_MOD),
                          ("repro/api/view.py", CONSUMER_BAD)],
                      [P.rules.CrossModuleDeterminismRule()])


def case_interproc_finding_is_suppressible(P):
    src = UNITS_POSITIVE.replace(
        "return payload_bytes + alpha_frac",
        "return payload_bytes + alpha_frac  # nimble: ignore[units] -- fixture: intentional mix")
    return _lint_many(P, [("repro/core/ufix.py", src)], [P.rules.UnitsRule()])


CASES = {name[5:]: fn for name, fn in sorted(globals().items()) if name.startswith("case_")}
#: cases whose fixtures the reference's own tests hold to at least one finding
FIRING = {
    "determinism_positive", "schema_discipline_positive", "schema_discipline_version_mismatch",
    "frozen_spec_positive", "float_eq_nan_flagged_everywhere",
    "float_eq_literal_in_sentinel_path", "suppression_without_reason_is_a_finding",
    "stale_suppression_is_a_finding", "unknown_suppression_is_a_finding",
    "stale_baseline_entry_is_a_finding", "injected_violation_is_caught",
    "units_mixing_in_one_function", "units_cross_module_signature_mismatch",
    "xmodule_hash_order_consumption_is_caught",
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_parity_with_the_reference_checker(name, tmp_path):
    fn = CASES[name]
    needs_tmp = "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]
    args = lambda sub: (tmp_path / sub,) if needs_tmp else ()
    if needs_tmp:
        (tmp_path / "ref").mkdir()
        (tmp_path / "port").mkdir()
    want = _norm(fn(REF, *args("ref")))
    got = _norm(fn(PORT, *args("port")))
    assert got == want
    if name in FIRING:
        assert got["findings"], "the fixture must fire"


def test_parity_covers_every_untraced_reference_case():
    """40 cases: ``tests/test_analysis.py``'s 35 less jit-purity's three, its
    two retrace ones and the five over ``src/repro`` (the shipped-tree tests
    below take those over), with float-eq's literal test and the
    stale/unknown suppression test two cases each (27); and
    ``tests/test_interproc.py``'s 17 less its four retrace ones (13)."""
    assert len(CASES) == 40


# -- injected violations -----------------------------------------------------------

def test_unseeded_torch_draws_in_core_are_determinism_findings():
    src = ("import torch\n"
           "def noise(n, seed):\n"
           "    g = torch.Generator().manual_seed(seed)\n"
           "    a = torch.randn(n, generator=g)\n"
           "    b = torch.randn(n)\n"
           "    torch.manual_seed(seed)\n"
           "    return a + b + torch.nan\n")
    rules = [PORT.rules.DeterminismRule()]
    found = PORT.a.analyze_source(src, path="repro_torch/core/fixture.py", rules=rules).findings
    assert [(f.rule, f.line) for f in found] == [("determinism", 5), ("determinism", 6)]
    assert "`torch.randn` without `generator=`" in found[0].message
    assert "torch.manual_seed" in found[1].message
    assert PORT.a.analyze_source(src, path="repro_torch/launch/fixture.py", rules=rules).clean
    nan = PORT.a.analyze_source("import torch\ndef f(x):\n    return x == torch.nan\n",
                                rules=[PORT.rules.FloatEqRule()])
    assert [f.rule for f in nan.findings] == ["float-eq"]


STEP_FIXTURE = '''
from ..core.reads import plan_read, stable_read


def make_train_step(model):
    def train_step(params, batch):
        return plan_read(batch) + stable_read(batch)
    return train_step
'''

READS_FIXTURE = '''
def plan_read(plan):
    return plan.sum().item()


def stable_read(x):
    return x.sum().item()
'''

LAUNCH_FIXTURE = '''
def report(plan):
    return plan.sum().item()
'''


def _host_sync(files):
    rule = PORT.rules.HostSyncRule()
    report = PORT.a.analyze_sources(files, rules=[rule])
    return report, [(s.path, s.function, s.detail, s.provenance) for s in rule.sites]


def test_host_sync_on_the_train_steps_path():
    report, sites = _host_sync([("repro_torch/train/step.py", STEP_FIXTURE),
                                ("repro_torch/core/reads.py", READS_FIXTURE),
                                ("repro_torch/launch/report.py", LAUNCH_FIXTURE)])
    (f,) = report.findings
    assert (f.rule, f.path, f.line) == ("host-sync", "repro_torch/core/reads.py", 3)
    assert "`item:plan.sum()` in `repro_torch.core.reads.plan_read` is PLAN_DEPENDENT" in \
        f.message
    assert sites == [
        ("repro_torch/core/reads.py", "repro_torch.core.reads.plan_read", "item:plan.sum()",
         "PLAN_DEPENDENT"),
        ("repro_torch/core/reads.py", "repro_torch.core.reads.stable_read", "item:x.sum()",
         "TOPOLOGY_STABLE"),
    ]


def test_host_sync_off_the_path_gives_nothing():
    report, sites = _host_sync([("repro_torch/launch/report.py", LAUNCH_FIXTURE),
                                ("repro_torch/core/reads.py", READS_FIXTURE)])
    assert report.clean and sites == []


def test_host_sync_site_kinds():
    """The reads, casts, data-sized ops, tests, uploads and stores the rule
    lists; a numpy array's ``.tolist()`` and the CPU route are none."""
    src = '''
import numpy as np
import torch


def make_train_step(model):
    def train_step(x: torch.Tensor, n: int, cache):
        a = x.cpu()
        b = float(x.sum())
        c = torch.nonzero(x)
        if x.any():
            pass
        d = torch.tensor(n, device=x.device)
        e = torch.as_tensor(np.arange(n)).to(x.device)
        x[0] = n
        f = np.arange(n).tolist()
        if x.device.type == "cpu":
            return x.item()
        torch.cuda.synchronize()
        return a, b, c, d, e, f
    return train_step
'''
    _, sites = _host_sync([("repro_torch/train/step.py", src)])
    assert [s[2] for s in sites] == [
        "cpu:x", "float:x.sum()", "nonzero:x", "if:x.any()", "upload:n",
        "upload:torch.as_tensor(np.arange(n))", "store:x[0]", "synchronize"]


# -- the shipped tree ----------------------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    """src/repro_torch linted once: the report, the host-sync rule, the
    contexts, the engine's program."""
    contexts = PORT.engine.build_contexts([PORT_SRC], rel_to=SRC)
    engine = PORT.a.AnalysisEngine(PORT.a.RULES, PORT.a.load_baseline())
    report = engine.run(contexts, root=PORT_SRC)
    rule = next(r for r in engine.rules if isinstance(r, PORT.rules.HostSyncRule))
    return types.SimpleNamespace(report=report, rule=rule, contexts=contexts,
                                 program=engine.program)


def test_rules_are_the_ports_in_order():
    assert [r.rule_id for r in PORT.a.RULES] == [
        "determinism", "schema-discipline", "frozen-spec", "float-eq", "host-sync", "units",
        "xmodule-determinism"]


def test_shipped_tree_is_clean_with_the_shipped_baseline(tree):
    assert tree.report.files > 100
    assert tree.report.clean, "\n".join(str(f) for f in tree.report.findings)
    assert not tree.report.suppressed
    assert {f.rule for f in tree.report.baselined} == {"host-sync"}
    obj = tree.report.to_json_obj()
    assert PORT.jsonio.parse_schema_id(obj["schema"]) == ("lint", 1)


def test_every_baseline_entry_is_host_sync_debt_with_its_roadmap_item(tree):
    entries = PORT.a.load_baseline(PORT.a.default_baseline_path())
    assert entries
    for e in entries:
        assert e["rule"] == "host-sync" and "PLAN_DEPENDENT" in e["message"]
        assert any(f"ROADMAP Queue 2 item {k} " in e["reason"] for k in (4, 7, 8)), e
    debt = PORT.a.collect_debt(tree.contexts, entries)
    assert debt["suppressions"] == [] and debt["total"] == len(entries)


def test_both_locks_are_fresh_and_line_free(tree):
    assert PORT.a.lock_is_fresh(PORT.a.default_lock_path(), tree.contexts)
    assert PORT.a.retrace_lock_is_fresh(PORT.a.default_retrace_lock_path(), tree.program,
                                        tree.rule.analysis)
    obj = json.loads(open(PORT.a.default_retrace_lock_path()).read())
    assert PORT.jsonio.parse_schema_id(obj["schema"]) == ("retrace_lock", 1)
    for key in obj["entries"]:
        parts = key.split(":")
        assert parts[0] == "host-sync" and parts[1].endswith(".py"), key
        assert not any(p.isdigit() for p in parts), key
    lock = json.loads(open(PORT.a.default_lock_path()).read())
    assert PORT.jsonio.parse_schema_id(lock["schema"]) == ("schemas_lock", 1)
    assert "lint" in lock["kinds"]


def test_inventory_holds_the_syncs_the_card_records(tree):
    """The (file, function) pairs the card's sync audit recorded on a
    paper-moe-8e train step and a decode step (``launch/sync_audit.py``)."""
    inv = PORT.a.build_retrace_inventory(tree.program, tree.rule.analysis)
    assert PORT.jsonio.parse_schema_id(inv["schema"]) == ("retrace", 1)
    assert json.loads(json.dumps(inv)) == inv
    assert {s["kind"] for s in inv["sites"]} == {"host-sync"}
    assert sum(inv["counts"].values()) == len(inv["sites"])
    listed = {(s["path"], s["function"].rsplit(".", 1)[-1]) for s in inv["sites"]}
    assert {("repro_torch/core/planner.py", "plan_flows_batch"),
            ("repro_torch/core/planner.py", "quantize_chunks"),
            ("repro_torch/kernels/grouped_ffn/ops.py", "grouped_ffn_bwd"),
            ("repro_torch/models/layers.py", "attention_decode")} <= listed
    plan = {s["function"] for s in inv["sites"] if s["provenance"] == "PLAN_DEPENDENT"}
    assert "repro_torch.kernels.grouped_ffn.ops.grouped_ffn_bwd" in plan


def test_sync_audit_matches_each_sync_warning_to_its_traced_sync():
    """The audit's warning hook, without a card: a sync warning raised in a
    function under ``src/repro_torch/`` is recorded at that function, the
    debug mode's prototype notice is no sync, and a warning without its
    traced sync (or the reverse) is unmatched and, when not inventoried,
    unlisted."""
    import warnings

    from repro_torch.launch import sync_audit as sa

    path = os.path.join(sa.PKG_DIR, "core", "planner.py")
    ns = {"warnings": warnings}
    exec(compile("def host_read(msg):\n    warnings.warn(msg)\n", path, "exec"), ns)
    log = sa.SyncLog()
    sa._LOG.append(log)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = sa._on_warning
            ns["host_read"](sa.SYNC_WARNING + " (Triggered internally)")
            ns["host_read"]("Synchronization debug mode is a prototype feature and "
                            "does not yet detect all synchronizing operations")
    finally:
        sa._LOG.pop()
    site = ("repro_torch/core/planner.py", "host_read")
    assert log.warned == [(*site, 2)] and log.warnings == 1
    assert sa.unmatched(log) == [site]
    assert sa.unlisted({"train": log}, set()) == [site]
    assert sa.unlisted({"train": log}, {site}) == []
    log.sites.append((*site, 2))
    assert sa.unmatched(log) == []
    log.sites.append(("repro_torch/core/planner.py", "plan_flows_batch", 173))
    assert sa.unmatched(log) == [("repro_torch/core/planner.py", "plan_flows_batch")]


def test_units_inventory_over_the_port_mixes_no_units(tree):
    obj = PORT.a.build_units_inventory(tree.program)
    assert PORT.jsonio.parse_schema_id(obj["schema"]) == ("units", 1)
    assert obj["seeds"] and obj["mixes"] == []


def test_cli_check_lock_and_debt(capsys):
    assert PORT.main.main(["--check-lock", "-q"]) == 0
    assert "[analysis] clean: " in capsys.readouterr().out
    assert PORT.main.main(["--debt"]) == 0
    out = capsys.readouterr().out
    assert "baselined [host-sync]" in out and "0 suppression(s)" in out

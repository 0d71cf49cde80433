"""The port's front door against the JAX orchestrator itself: fair-share
scheduling, swap/sacrifice decode preemption, autoscaling, members on
their own hardware profiles, and every orchestrator path ported before.

The JAX orchestrator does not import as ``repro.serving.orchestrator`` on
Python 3.12: its config gives a dataclass field a ``ControllerConfig``
instance as default, which the dataclass machinery refuses because the
class is unhashable.  The ``oracle`` fixture loads the unchanged file
under a private module name, with ``ControllerConfig.__hash__`` set only
while the module executes and restored right after.  The real module name
stays out of ``sys.modules``, so the JAX tests that import it inside
their bodies fail as they do without this file, whichever test ran first.

Both sides run ``TINY`` in float32 on the CPU, on the same JAX weights
(the port's through ``params_from_jax``), billed on the same
``TPU_V5E`` profile, over workloads each package generates from the same
seed.  Tolerances: token streams, outcomes, preemption and rejection
counts and fleet compositions exactly; every float of ``summary()`` and
of the timelines within 1e-9 relative (NaN equal to NaN).
"""
import importlib.util
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from conftest import TINY, TINY_ECFG, assert_pools_restored
from repro.core import analytical as JA
from repro.core import migration as JM
from repro.serving import api as JAPI
from repro.serving import autoscale as JAS
from repro.serving import fairshare as JFS
from repro.serving import workload as JWL
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.core import analytical as A
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.weights import params_from_jax
from repro_torch.serving import api as PAPI
from repro_torch.serving import autoscale as PAS
from repro_torch.serving import fairshare as PFS
from repro_torch.serving import workload as PWL
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.orchestrator import Orchestrator, OrchestratorConfig

ORACLE = "repro.serving._orchestrator_oracle"
PTINY = ModelConfig(name="tiny4", family=Family.DENSE, n_layers=4,
                    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                    vocab_size=128)
ECFG = EngineConfig(max_len=TINY_ECFG.max_len, max_batch=TINY_ECFG.max_batch,
                    block_size=TINY_ECFG.block_size)
REL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def oracle():
    """The unchanged JAX orchestrator, loaded under a private name."""
    mod = sys.modules.get(ORACLE)
    if mod is None:
        path = Path(JAPI.__file__).parent / "orchestrator.py"
        spec = importlib.util.spec_from_file_location(ORACLE, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[ORACLE] = mod          # dataclasses look it up
        saved = JM.ControllerConfig.__dict__["__hash__"]
        JM.ControllerConfig.__hash__ = object.__hash__
        try:
            spec.loader.exec_module(mod)
        finally:
            JM.ControllerConfig.__hash__ = saved
    assert JM.ControllerConfig.__hash__ is None
    assert "repro.serving.orchestrator" not in sys.modules
    return mod


@pytest.fixture(scope="module")
def port_params(tiny_params):
    return params_from_jax(PTINY, jax.tree.map(np.asarray, tiny_params),
                           device="cpu")


@pytest.fixture(scope="module")
def sides(oracle, tiny_params, port_params):
    """(JAX, port): one namespace per package with the same names."""
    def jax_orch(engine=None, **kw):
        return oracle.Orchestrator(
            TINY, tiny_params, oracle.OrchestratorConfig(
                engine=engine or TINY_ECFG, hw=JA.TPU_V5E, **kw))

    def port_orch(engine=None, **kw):
        return Orchestrator(PTINY, port_params, OrchestratorConfig(
            engine=engine or ECFG, hw=A.TPU_V5E, **kw), device="cpu")

    j = SimpleNamespace(orch=jax_orch, A=JA, ECfg=JEngineConfig, api=JAPI,
                        fs=JFS, asc=JAS, wl=JWL)
    p = SimpleNamespace(orch=port_orch, A=A, ECfg=EngineConfig, api=PAPI,
                        fs=PFS, asc=PAS, wl=PWL)
    return j, p


def workload(S, n, seed=3, max_new=6, **kw):
    """``conftest.make_workload`` from either package's generator."""
    base = dict(kind="synthetic", rps=1000.0, n_requests=n,
                vocab_size=TINY.vocab_size, max_new_tokens=max_new,
                prefix_share=0.5, n_prefix_groups=2, seed=seed,
                prompt_len_lo=16, prompt_len_hi=48)
    base.update(kw)
    return S.wl.generate(S.wl.WorkloadConfig(**base))


def assert_same(a, b, path="summary"):
    """Equal key by key; floats within REL relative, NaN equal to NaN."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), \
            f"{path}: keys {sorted(set(a) ^ set(b))}"
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, (float, np.floating)) and not isinstance(a, bool):
        a, b = float(a), float(b)
        assert (math.isnan(a) and math.isnan(b)) or \
            math.isclose(a, b, rel_tol=REL, abs_tol=0.0), f"{path}: {a} {b}"
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def resident(orch):
    return [r.rid for u in orch.decode_units() for r in u.slots
            if r is not None]


def streams(handles):
    return {h.rid: (h.outcome.value, h.tokens) for h in handles}


def both(sides, scenario, *args):
    """Run ``scenario(S, *args)`` on each side; hold the port's streams
    and summary to the oracle's.  Returns (the port's result, the
    oracle's)."""
    j, p = sides
    want = scenario(j, *args)
    got = scenario(p, *args)
    assert streams(got.handles) == streams(want.handles)
    assert_same(got.srv.summary(), want.srv.summary())
    return got, want


def plain_streams(S, wl_kw, **ocfg):
    srv = S.api.Server(S.orch(**ocfg))
    hs = [srv.submit(r, at=r.arrival) for r in workload(S, **wl_kw)]
    srv.drain()
    return streams(hs)


# ---------------------------------------------------------------------------
# (a) forced preemption of every request, mid-decode
# ---------------------------------------------------------------------------

def forced(S, mode):
    orch = S.orch(n_prefill=2, n_decode=2, chunk_tokens=8)
    srv = S.api.Server(orch)
    hs = [srv.submit(r, at=r.arrival)
          for r in workload(S, n=5, seed=11, max_new=8)]
    hit = []
    for _ in range(400):
        if not srv.step() and srv.in_flight() == 0:
            break
        for rid in resident(orch):
            h = srv.handles[rid]
            if rid not in hit and not h.finished and len(h.tokens) >= 2:
                assert orch.preempt(rid, mode)
                hit.append(rid)
                break
    srv.drain()
    return SimpleNamespace(orch=orch, srv=srv, handles=hs, hit=hit)


@pytest.mark.parametrize("mode", ["swap", "sacrifice"])
def test_forced_preemption_matches_oracle(sides, mode):
    got, want = both(sides, forced, mode)
    assert got.hit == want.hit and len(got.hit) == 5
    ref = plain_streams(sides[1], dict(n=5, seed=11, max_new=8),
                        n_prefill=2, n_decode=2, chunk_tokens=8)
    assert streams(got.handles) == ref
    s = got.srv.summary()
    assert s[f"n_preempted_{mode}"] == 5
    if mode == "swap":
        assert s["pages_swapped"] > 0 and got.orch.swap_io_s > 0
        assert got.orch.swap_io_s == pytest.approx(want.orch.swap_io_s,
                                                   rel=REL)
    assert_pools_restored(got.orch)


# ---------------------------------------------------------------------------
# (b) natural preemption under two tenants; (c) budgets that reject
# ---------------------------------------------------------------------------

def two_tenants(S, mode):
    """Three bronze requests fill the one decode member; three gold ones
    arrive once all three are decode-resident."""
    fs = S.fs
    orch = S.orch(n_prefill=1, n_decode=1, chunk_tokens=8)
    srv = S.api.Server(orch, scheduler=fs.SchedulerConfig(
        preemption=mode, tenants={
            "bronze": fs.TenantPolicy(priority=0),
            "gold": fs.TenantPolicy(weight=4, priority=1)}))
    reqs = workload(S, n=6, seed=5, max_new=10)
    for i, r in enumerate(reqs):
        r.tenant = "bronze" if i < 3 else "gold"
    hs = [srv.submit(r, at=0.0) for r in reqs[:3]]
    while len(resident(orch)) < 3:
        srv.step()
    hs += [srv.submit(r) for r in reqs[3:]]
    srv.drain()
    return SimpleNamespace(orch=orch, srv=srv, handles=hs)


@pytest.mark.parametrize("mode", ["swap", "sacrifice"])
def test_two_tenant_preemption_matches_oracle(sides, mode):
    got, want = both(sides, two_tenants, mode)
    s = got.srv.summary()
    assert s[f"n_preempted_{mode}"] >= 1
    assert all(o == "completed" for o, _ in streams(got.handles).values())
    assert set(s["tenants"]) == {"bronze", "gold"}
    assert_pools_restored(got.orch)


def budgets(S):
    fs = S.fs
    srv = S.api.Server(S.orch(n_prefill=1, n_decode=1), scheduler=
                       fs.SchedulerConfig(tenants={
                           "a": fs.TenantPolicy(max_inflight_requests=2),
                           "b": fs.TenantPolicy(rate_rps=200.0, burst=1),
                           "c": fs.TenantPolicy(max_inflight_tokens=70)}))
    reqs = workload(S, n=12, seed=7, max_new=6)
    for i, r in enumerate(reqs):
        r.tenant = "abc"[i % 3]
    hs = [srv.submit(r, at=0.0) for r in reqs]
    srv.drain()
    return SimpleNamespace(srv=srv, handles=hs)


def test_fair_share_budget_rejections_match_oracle(sides):
    got, want = both(sides, budgets)
    rej = got.srv.summary()["sched_rejections"]
    assert set(rej) == {"concurrency", "rate", "tokens"}, rej
    assert rej == want.srv.summary()["sched_rejections"]


# ---------------------------------------------------------------------------
# (d) seeded step / preempt / abort interleavings
# ---------------------------------------------------------------------------

def chaos(S, seed):
    rng = np.random.default_rng(seed)
    orch = S.orch(n_prefill=2, n_decode=2, chunk_tokens=8)
    srv = S.api.Server(orch)
    hs = [srv.submit(r, at=r.arrival)
          for r in workload(S, n=6, seed=23 + seed, max_new=6)]
    n_aborts = 0
    for _ in range(500):
        if srv.in_flight() == 0:
            break
        op = rng.random()
        if op < 0.25:
            res = resident(orch)
            if res:
                rid = int(rng.choice(res))
                mode = ("swap", "sacrifice")[int(rng.integers(2))]
                if srv.handles[rid].tokens:
                    orch.preempt(rid, mode)
                continue
        if op < 0.30 and n_aborts < 2:
            live = [h for h in hs if not h.finished]
            if live:
                n_aborts += live[int(rng.integers(len(live)))].cancel()
                continue
        srv.step()
    srv.drain()
    return SimpleNamespace(orch=orch, srv=srv, handles=hs)


@pytest.mark.parametrize("seed", [0, 1])
def test_preempt_abort_interleavings_match_oracle(sides, seed):
    got, want = both(sides, chaos, seed)
    s = got.srv.summary()
    assert s["n_preempted_swap"] + s["n_preempted_sacrifice"] > 0
    assert s["n_aborted"] > 0
    assert_pools_restored(got.orch)


# ---------------------------------------------------------------------------
# (e)-(g) autoscaling and members on their own parts
# ---------------------------------------------------------------------------

def scale_up_down(S):
    # Algorithm 1 off: at its default cadence it would tick ~10^6 times
    # before the spawned member's 2 s warm-up ends
    orch = S.orch(n_prefill=1, n_decode=2, chunk_tokens=8, migration=False)
    srv = S.api.Server(orch)
    hs = [srv.submit(r, at=r.arrival)
          for r in workload(S, n=6, seed=13, max_new=10)]
    name = orch._scale_up("decode", S.A.TPU_V5P)
    spawned = orch._by_name[name]
    warming = (spawned.warming_until > orch.clock.now,
               orch.fleet[name] == "decode:warming")
    drained = False
    for _ in range(800):
        alive = srv.step()
        if not drained and any(u.active for u in orch.decode_units()):
            drained = orch._scale_down("decode")
        if not alive and srv.in_flight() == 0:
            break
    srv.drain()
    return SimpleNamespace(orch=orch, srv=srv, handles=hs, name=name,
                           warming=warming, drained=drained,
                           spawned=spawned)


def test_scale_up_and_drain_match_oracle(sides):
    got, want = both(sides, scale_up_down)
    assert got.warming == (True, True) and got.drained
    assert [m.name for m in got.orch.retired] == \
        [m.name for m in want.orch.retired] != []
    assert streams(got.handles) == plain_streams(
        sides[1], dict(n=6, seed=13, max_new=10), n_prefill=1, n_decode=2,
        chunk_tokens=8)
    assert_same(got.orch.metrics.fleet_timeline,
                want.orch.metrics.fleet_timeline, "fleet_timeline")
    # the spawned engine decodes over the same parameter tensors
    e = got.spawned.decode
    assert e.params is got.orch.params and e.device.type == "cpu"
    assert_pools_restored(got.orch)


def autoscaled(S):
    """A burst into a 1p/1d fleet: the policy orders a member per tier,
    then drains both once idle (cadences at TINY's microsecond scale)."""
    orch = S.orch(n_prefill=1, n_decode=1, chunk_tokens=8,
                  control_interval=2e-6, migration=False)
    srv = S.api.Server(orch, autoscaler=S.asc.AutoscaleConfig(
        interval_s=2e-6, cooldown_s=4e-6, jit_compile_s=1e-5,
        target_delay_s=1e-6, low_util=0.5, max_prefill=2, max_decode=3,
        profiles=(S.A.TPU_V5P,)))
    hs = [srv.submit(r, at=r.arrival)
          for r in workload(S, n=12, seed=17, max_new=12, rps=1e7)]
    srv.drain()
    return SimpleNamespace(orch=orch, srv=srv, handles=hs)


def test_policy_driven_autoscaling_matches_oracle(sides):
    got, want = both(sides, autoscaled)
    dec = [(t, d.role, d.delta, d.profile and d.profile.name, d.reason)
           for t, d in got.orch.autoscaler.decisions]
    assert dec == [(t, d.role, d.delta, d.profile and d.profile.name,
                    d.reason) for t, d in want.orch.autoscaler.decisions]
    assert {(r, d) for _, r, d, _, _ in dec} == {
        ("prefill", 1), ("decode", 1), ("prefill", -1), ("decode", -1)}, dec
    assert got.srv.summary()["n_retired"] == 2
    assert_same(got.orch.metrics.fleet_timeline,
                want.orch.metrics.fleet_timeline, "fleet_timeline")
    assert_same(got.orch.metrics.util_timeline,
                want.orch.metrics.util_timeline, "util_timeline")
    assert all(o == "completed" for o, _ in streams(got.handles).values())
    assert_pools_restored(got.orch)


def profiled(S):
    srv = S.api.Server(S.orch(n_prefill=2, n_decode=2, chunk_tokens=8,
                              hw_profiles=(S.A.TPU_V5E, S.A.TPU_V5P)))
    hs = [srv.submit(r, at=r.arrival)
          for r in workload(S, n=6, seed=19, max_new=6)]
    srv.drain()
    return SimpleNamespace(srv=srv, handles=hs)


def test_hw_profiles_fleet_matches_oracle(sides):
    got, _ = both(sides, profiled)
    hws = {m.name: m.hw.name for m in got.srv.backend.members}
    assert hws == {"prefill0": "tpu_v5e", "prefill1": "tpu_v5p",
                   "decode0": "tpu_v5e", "decode1": "tpu_v5p"}


# ---------------------------------------------------------------------------
# (h) refusals
# ---------------------------------------------------------------------------

def test_refusals(sides):
    _, p = sides
    with pytest.raises(ValueError, match="decode_split"):
        p.orch(decode_split=2).set_autoscaler(PAS.AutoscaleConfig())
    orch = p.orch(n_prefill=1, n_decode=1)
    srv = p.api.Server(orch)
    for r in workload(p, n=2, max_new=4):
        srv.submit(r, at=r.arrival)
    assert not orch.preempt(0, "swap")     # nothing decode-resident yet
    with pytest.raises(ValueError):
        orch.preempt(0, "migrate")         # unknown mode
    with pytest.raises(ValueError):
        orch.preempt(0)                    # no scheduler: no default mode
    srv.drain()
    assert srv.summary()["n_preempted_swap"] == 0


# ---------------------------------------------------------------------------
# (i) the orchestrator paths ported before, against the oracle
# ---------------------------------------------------------------------------

PATHS = {
    "plain": dict(prefix_sharing=False),
    "prefix_sharing": dict(),
    "chunked": dict(chunk_tokens=8),
    "ngram": dict(chunk_tokens=8, speculation="ngram"),
    "decode_split2": dict(chunk_tokens=8, decode_split=2),
}


def path_run(S, name):
    kw = dict(PATHS[name])
    spec = kw.pop("speculation", "off")
    engine = S.ECfg(max_len=ECFG.max_len, max_batch=ECFG.max_batch,
                    block_size=ECFG.block_size, speculation=spec)
    srv = S.api.Server(S.orch(n_prefill=2, n_decode=2, engine=engine, **kw))
    hs = [srv.submit(r, at=r.arrival)
          for r in workload(S, n=6, seed=29, max_new=8)]
    srv.drain()
    return SimpleNamespace(srv=srv, handles=hs)


@pytest.mark.parametrize("name", list(PATHS))
def test_ported_paths_match_oracle(sides, name):
    got, _ = both(sides, path_run, name)
    assert got.srv.summary()["n_requests"] == 6
    assert_pools_restored(got.srv.backend)


# ---------------------------------------------------------------------------
# (g) the batch drive: Orchestrator.run
# ---------------------------------------------------------------------------

def batch_run(S, name, drive):
    """One ``PATHS`` fleet with the clock's event log on, driven by
    ``Orchestrator.run`` (``drive="orch"``) or ``Server.run``."""
    kw = dict(PATHS[name])
    spec = kw.pop("speculation", "off")
    engine = S.ECfg(max_len=ECFG.max_len, max_batch=ECFG.max_batch,
                    block_size=ECFG.block_size, speculation=spec)
    orch = S.orch(n_prefill=2, n_decode=2, engine=engine, trace_events=True,
                  **kw)
    reqs = workload(S, n=6, seed=29, max_new=8)
    summary = (orch.run(reqs) if drive == "orch"
               else S.api.Server(orch).run(reqs))
    return SimpleNamespace(
        orch=orch, summary=summary, trace=list(orch.clock.trace),
        streams={r.rid: (r.outcome.value, list(r.generated)) for r in reqs})


@pytest.mark.parametrize("name", ["plain", "chunked", "ngram",
                                  "decode_split2"])
def test_orchestrator_run_matches_oracle_and_server(sides, name):
    """``Orchestrator.run`` equals the oracle's ``run`` event for event
    (kinds exactly, virtual times within REL) with the same streams and
    ``summary()``, and equals the port's own ``Server.run`` on the same
    requests exactly."""
    j, p = sides
    want = batch_run(j, name, "orch")
    got = batch_run(p, name, "orch")
    assert got.streams == want.streams
    assert len(got.streams) == 6 and all(
        o == "completed" for o, _ in got.streams.values())
    assert [k for _, k in got.trace] == [k for _, k in want.trace]
    assert_same([t for t, _ in got.trace], [t for t, _ in want.trace],
                "trace")
    assert_same(got.summary, want.summary)
    served = batch_run(p, name, "server")
    assert served.trace == got.trace and served.streams == got.streams
    assert repr(served.summary) == repr(got.summary)   # NaN equal to NaN
    assert_pools_restored(got.orch)


def test_orchestrator_run_names_lost_requests(sides):
    """A request left without an outcome after the drain raises
    ``RuntimeError`` naming it, on both sides (the drain is stubbed out
    so that nothing is served)."""
    for S in sides:
        orch = S.orch(n_prefill=1, n_decode=1)
        reqs = workload(S, n=3, seed=5)
        orch.drain = lambda max_events: []
        with pytest.raises(RuntimeError, match=r"lost requests \[0, 1, 2\]"):
            orch.run(reqs)

"""The port's serving CLI (``repro_torch.launch.serve``) and the simulator
it drives, against the JAX package's: the copied ``ClusterSim`` and
``PipelineModel`` give the reference's numbers, the sim backend prints
what the JAX CLI prints (whose sim path never imports the JAX
orchestrator), the live backend serves the arch's smoke size on the CPU
when asked, and without a card and without ``--device cpu`` it raises.

Tolerances: printed output exactly; summaries and pipeline times within
1e-9 relative (NaN equal to NaN), as in ``test_torch_frontdoor.py``.
"""
import runpy
import sys
from pathlib import Path

import pytest
import torch

from repro import configs as jconfigs
from repro.core import pipeline as JP
from repro.launch import serve as jserve
from repro.serving import cluster as JC
from repro.serving import workload as JW
from repro_torch import configs
from repro_torch.core import pipeline as PP
from repro_torch.launch import serve
from repro_torch.serving import cluster as PC
from repro_torch.serving import workload as PW
from test_torch_frontdoor import assert_same


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("system", ["banaserve", "distserve", "vllm"])
def test_cluster_sim_copy_matches_jax(system):
    """Each preset over the same workload (banaserve's with Algorithm 1
    on): summaries and migration logs equal."""
    kw = dict(kind="longbench", rps=2, n_requests=30, seed=1,
              max_new_tokens=64)
    out = []
    for C, W, cfgs in ((JC, JW, jconfigs), (PC, PW, configs)):
        scfg = C.SimConfig.preset(cfgs.get("llama-13b"), system)
        sim = C.ClusterSim(scfg, W.WorkloadConfig(**kw))
        out.append((sim.run(), [(t, a.kind.value, a.src, a.dst, a.amount,
                                 a.predicted_cost)
                                for t, a in sim.migration_log]))
    (js, jlog), (ps, plog) = out
    assert ps["n_requests"] == 30
    assert_same(plog, jlog, "migration_log")
    assert_same(ps, js)


@pytest.mark.parametrize("args", [(1, 0.03125, 0.0625), (32, 4.2e-3, 8e-5),
                                  (7, 1e-3, 1e-3)])
def test_pipeline_model_copy_matches_jax(args):
    """Every timing, the timeline and the paper's worked example; the
    first case is R3's, which the copy keeps."""
    j, p = JP.PipelineModel(*args), PP.PipelineModel(*args)
    for f in ("serial_time", "overlapped_time", "residual_stall",
              "fully_hidden", "timeline"):
        assert_same(getattr(p, f)(), getattr(j, f)(), f)
    assert_same(PP.paper_example().overlapped_time(),
                JP.paper_example().overlapped_time(), "paper_example")
    if args[0] == 1:
        assert p.overlapped_time() > p.serial_time()       # R3, kept


SIM_ARGS = [
    ["--backend", "sim", "--smoke"],
    ["--backend", "sim", "--smoke", "--system", "distserve",
     "--speculation", "ngram", "--workload", "synthetic"],
    ["--backend", "sim", "--smoke", "--autoscale",
     "--profiles", "tpu_v5e,tpu_v5p"],
    ["--backend", "sim", "--closed-loop", "3", "--admission-limit", "4",
     "--requests", "10"],
    ["--backend", "sim", "--smoke", "--arch", "granite-moe-3b-a800m"],
]


@pytest.mark.parametrize("argv", SIM_ARGS, ids=lambda a: " ".join(a[2:]))
def test_sim_cli_prints_what_the_jax_cli_prints(argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    want = capsys.readouterr().out
    assert "repro.serving.orchestrator" not in sys.modules
    s = serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert s["n_requests"] + s["n_rejected"] == s["n_submitted"] > 0


@pytest.mark.parametrize("extra", [[], ["--autoscale", "--profiles",
                                        "h100_sxm"]])
def test_live_cli_serves_smoke_size_on_the_cpu(extra, capsys):
    s = serve.main(["--backend", "live", "--smoke", "--device", "cpu",
                    "--requests", "6", "--max-new", "6"] + extra)
    out = capsys.readouterr().out
    assert s["n_requests"] == s["n_submitted"] == 6
    assert "== 6 completed / 0 rejected / 0 aborted of 6 submitted" in out
    if extra:
        assert "autoscale:" in out


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "grok-1-314b"])
def test_live_cli_serves_moe_smoke_size_on_the_cpu(arch, capsys):
    s = serve.main(["--backend", "live", "--smoke", "--device", "cpu",
                    "--arch", arch, "--requests", "4", "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out
    assert s["n_requests"] == s["n_submitted"] == 4


@pytest.mark.parametrize("backend", ["live", "sim"])
def test_cli_needs_a_card_unless_cpu_is_asked(backend, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--backend", backend, "--smoke"])


# ---------------------------------------------------------------------------
# The ported examples
# ---------------------------------------------------------------------------

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    """An example script's namespace, loaded without running it."""
    return runpy.run_path(str(EXAMPLES / name), run_name="example")


def test_simulate_cluster_example_prints_what_jax_prints(capsys):
    """``examples/torch_simulate_cluster.py`` prints, line for line, what
    ``examples/simulate_cluster.py`` prints (its four workload runs)."""
    _example("simulate_cluster.py")["main"]()
    want = capsys.readouterr().out
    _example("torch_simulate_cluster.py")["main"]()
    got = capsys.readouterr().out
    assert got == want
    assert got.count("banaserve") == 4


@pytest.mark.parametrize("speculation", ["off", "ngram"])
def test_serve_disaggregated_example_on_the_cpu(speculation, capsys):
    """``examples/torch_serve_disaggregated.py --device cpu`` runs to its
    end: the mid-run submission, at least one applied migration and every
    stream token-identical to a single-engine rollout (its own asserts)."""
    _example("torch_serve_disaggregated.py")["main"](
        ["--device", "cpu", "--speculation", speculation])
    out = capsys.readouterr().out
    assert "submitted request 999 mid-run" in out
    assert "all 15 streamed outputs (incl. the mid-run submission) " \
        "token-identical to the single-engine reference" in out
    if speculation == "ngram":
        assert "speculation=ngram: tokens/decode-iter=" in out


def test_serve_disaggregated_example_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example("torch_serve_disaggregated.py")["main"]([])

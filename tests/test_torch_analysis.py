"""The port's static checker (repro_torch.analysis) and plan autotuner
(repro_torch.kernels.autotune), on the CPU.

  * each lint rule fires on its seeded fixture (tests/torch_analysis_fixtures/)
    and is silent on its clean twin; noqa parsing; per-tick detection only
    under the per-tick paths; the port's tree lint-clean;
  * the kernel contracts over every route x config (100% coverage), seeded
    violations (an empty split, a cluster of 16 without the non-portable
    attribute, shared memory over budget, a TMA stride not a multiple of 16
    bytes, a grid that stops short), a recorded ptxas log of an H100 build
    parsed to its registers and spills, and a seeded log with spills over
    budget or an entry function of no kernel;
  * autotune cache hygiene on tmp_path (bad entries rejected, reported as
    KCV007), keys round-tripping, get_plan with no cache equal to the plan
    functions for every route x config x M, a cache entry and an override
    winning in that order;
  * the CLI's exit codes.
"""
import json
import os

import pytest
import torch

from repro_torch.analysis import kernel_contracts as kc
from repro_torch.analysis import lints
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.kernels import autotune
from repro_torch.kernels import bnn_matmul as bnn
from repro_torch.kernels import cac_matmul as cac
from repro_torch.kernels import geometry
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attn as pa
from repro_torch.kernels import qnn_matmul as qnn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "torch_analysis_fixtures")
PTXAS_LOG = os.path.join(FIXTURES, "ptxas_h100.log")


def _fixture(name):
    return os.path.join(FIXTURES, name)


def _lint_as(name, rel):
    """Lint a fixture as if it lay at ``rel`` (the per-tick paths match by suffix)."""
    with open(_fixture(name), encoding="utf-8") as fh:
        linter = lints._Linter(_fixture(name), rel, fh.read())
    linter.visit(linter.tree)
    return linter.findings


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    """The autotune cache at a fresh file under tmp_path."""
    path = tmp_path / "autotune_torch.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    autotune.clear_cache()
    yield path
    autotune.clear_cache()


@pytest.fixture(scope="module")
def zoo_report(tmp_path_factory):
    """One contract run over the whole zoo with the recorded ptxas log."""
    old = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(tmp_path_factory.mktemp("c") / "none.json")
    autotune.clear_cache()
    try:
        with open(PTXAS_LOG, encoding="utf-8") as fh:
            yield kc.run(ptxas_log=fh.read())
    finally:
        if old is None:
            os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE", None)
        else:
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = old
        autotune.clear_cache()


# ---------------------------------------------------------------------------
# Lints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("code,n_expected", [
    ("RPA001", 8),
    ("RPA002", 4),
    ("RPA004", 2),
    ("RPA005", 1),
])
def test_rule_fires_on_seeded_fixture(code, n_expected):
    findings = lints.lint_file(_fixture(f"{code.lower()}_bad.py"), root=ROOT)
    assert len(findings) == n_expected, [f.render() for f in findings]
    assert all(f.code == code and f.line for f in findings)


@pytest.mark.parametrize("code", ["RPA001", "RPA002", "RPA004", "RPA005"])
def test_clean_twin_is_silent(code):
    findings = lints.lint_file(_fixture(f"{code.lower()}_ok.py"), root=ROOT)
    assert findings == [], [f.render() for f in findings]


def test_rpa003_fires_in_per_tick_code_only():
    bad = _lint_as("rpa003_bad.py", "serve/scheduler.py")
    assert [f.code for f in bad] == ["RPA003"] * 3
    assert _lint_as("rpa003_ok.py", "serve/scheduler.py") == []
    # the same branches outside a per-tick path are no finding
    assert _lint_as("rpa003_bad.py", "models/x.py") == []


def test_noqa_parsing():
    assert lints._noqa_codes(["x = 1  # noqa: E501"], 1) is None
    assert lints._noqa_codes(["x = 1  # repro: noqa"], 1) == set()
    assert lints._noqa_codes(
        ["x = t.cpu()  # repro: noqa-RPA001 -- the host streams tokens"], 1) == {"RPA001"}
    assert lints._noqa_codes(["# repro: noqa-RPA005 -- wall span", "x = 1"], 2) == {"RPA005"}
    assert lints._noqa_codes(["# repro: noqa-RPA005", "y = 2", "x = 1"], 3) is None


@pytest.mark.parametrize("rel,fn,hot", [
    ("serve/scheduler.py", "_run_tick", True), ("serve/scheduler.py", "_run_spec_tick", True),
    ("serve/engine.py", "step_batch", True), ("train/steps.py", "train_step", True),
    ("models/x.py", "_run_tick", False), ("serve/engine.py", "run", False),
])
def test_per_tick_detection_follows_the_path(rel, fn, hot):
    src = f"import torch\n\n\ndef {fn}(self, tok):\n    return tok.cpu().numpy()\n"
    linter = lints._Linter("x.py", rel, src)
    linter.visit(linter.tree)
    assert [f.code for f in linter.findings] == (["RPA001", "RPA001"] if hot else [])


def test_port_tree_is_lint_clean():
    rep = lints.run(ROOT)
    assert rep.ok, rep.render()
    assert rep.data["lints"]["n_files"] > 80


# ---------------------------------------------------------------------------
# Kernel contracts
# ---------------------------------------------------------------------------


def test_contract_zoo_full_coverage(zoo_report):
    assert zoo_report.ok, zoo_report.render()
    data = zoo_report.data["kernel_contracts"]
    covered, total = data["coverage"].split("/")
    assert covered == total == str(len(ops.KERNEL_ROUTES) * len(ARCH_NAMES))
    assert {e["route"] for e in data["entries"]} == set(ops.KERNEL_ROUTES)
    assert {e["arch"] for e in data["entries"]} == set(ARCH_NAMES)
    for e in data["entries"]:
        assert e["ok"] and 0 < e["smem_bytes"] <= data["smem_budget"] or e["smem_bytes"] == 0
        assert "grid" in e["launches"][-1] and "plan" in e
    # every entry function of the recorded build maps to a kernel, 1 to 11
    kernels = {k for row in data["ptxas"] for k in row["kernels"]}
    assert kernels == set(range(1, 12))


def test_recorded_ptxas_log_parses():
    with open(PTXAS_LOG, encoding="utf-8") as fh:
        parsed = kc.parse_ptxas(fh.read())
    assert len(parsed) == 64  # every entry function of the five sources
    entries = {(e["stem"], e["targs"]): e for e in parsed}
    e = entries[("stream_kernel", (0, 0, 8))]  # kernel 1, 8-row tiles
    assert (e["registers"], e["smem"], e["spill_stores"], e["spill_loads"]) == (128, 45056, 124,
                                                                                 104)
    assert entries[("stream_kernel", (0, 1, 8))]["spill_stores"] == 96
    assert entries[("bnn_bwd_kernel", (0, 0, 160))]["registers"] == 255  # kernel 9
    assert entries[("cac_train_bwd_dw_kernel", (1, 4))]["spill_stores"] == 36  # kernel 4
    assert kc.entry_kernels(entries[("qnn_kernel", (32,))]) == (10,)
    assert kc.symbol_stem("_ZN6stream13stream_kernelILi3ELb1ELi4EEEvPKvS2_PKhPfiiii") == (
        "stream_kernel", (3, 1, 4))


def test_seeded_log_over_budget_and_unmapped_entry():
    with open(PTXAS_LOG, encoding="utf-8") as fh:
        log = fh.read()
    over = log.replace("96 bytes stack frame, 124 bytes spill stores",
                       "96 bytes stack frame, 200 bytes spill stores")
    assert over != log
    fs, _ = kc.check_ptxas(kc.parse_ptxas(over))
    assert [f.code for f in fs] == ["KCV004"] and "200 B of spill stores" in fs[0].message
    stray = log + ("ptxas info    : Compiling entry function '_ZN3foo10mystery_kernelEv' for "
                   "'sm_90a'\nptxas info    : Used 300 registers, used 0 barriers\n")
    fs, _ = kc.check_ptxas(kc.parse_ptxas(stray))
    assert [f.code for f in fs] == ["KCV001"]


def test_seeded_empty_split():
    # 120 groups of K = 960 in 7 splits of 20: the seventh is empty
    fs, entry = kc.check_plan("hw_fwd", (4, 960, 2560), (4, 7, 20))
    assert [f.code for f in fs] == ["KCV002"] and "exactly once" in fs[0].message
    assert not entry["ok"]
    assert kc.check_plan("hw_fwd", (4, 960, 2560), (4, 8, 15))[0] == []


def test_seeded_nonportable_cluster():
    # kernel 2's launcher sets no non-portable attribute: 16 is past 8
    fs, _ = kc.check_plan("train_fwd", (512, 1024, 2560), (16, 4))  # 64 slices, 4 a split
    assert [f.code for f in fs] == ["KCV002"] and "NonPortable" in fs[0].message
    # kernels 5 and 3 set it: a cluster of 16 holds
    assert kc.check_plan("train_bwd", (512, 960, 2560), 16)[0] == []


def test_seeded_smem_over_budget():
    fs, entry = kc.check_plan("train_bwd", (512, 960, 2560), 8, smem_budget=64 * 1024)
    assert {f.code for f in fs} == {"KCV004"}
    assert entry["smem_bytes"] > 64 * 1024


def test_seeded_tma_stride():
    tmap = dict(name="g", rows=64, cols=10, ld=10, elem=4, box_rows=128, box_cols=32)
    fs = kc.check_tma("seeded", tmap)
    assert [f.code for f in fs] == ["KCV002"] and "16 bytes" in fs[0].message
    assert kc.check_tma("seeded", dict(tmap, ld=12)) == []
    assert [f.code for f in kc.check_tma("seeded", dict(tmap, ld=12, box_rows=512))] == ["KCV002"]


def test_seeded_grid_short_of_its_operand():
    launch = geometry.launches("hw_fwd", (4, 960, 2560), (4, 8, 15))[0]
    launch["axes"] = [("n", 2560, 128, 19)]  # one tile short of N
    fs, _ = kc.check_launch("seeded", launch)
    assert [f.code for f in fs] == ["KCV003"]


def _broad_plans(path, m, k, n):
    """Plans of ``path`` at (m, k, n) well past what its launcher takes:
    every tile of the enumeration and one more, up to 17 splits."""
    groups = -(-k // 8)
    stream = [(mt, s, per) for mt in (2, 4, 8) for s in range(1, 18)
              for per in {-(-groups // s), -(-groups // s) + 1, max(1, groups // s)}]
    product = [(bn, s, per) for bn in (96, 128, 160) for s in (1, 2, 8, 9)
               for per in (64, 100, 128, 512)]
    return {
        "hw_fwd": stream, "bnn_packed": stream,
        "train_fwd": [(s, per) for s in range(1, 18) for per in range(1, 70)],
        "train_bwd": list(range(1, 20)),
        "train_bwd_dw": [(nt, p) for nt in (2, 4, 8) for p in range(1, 400, 13)],
        "bnn": [("stream",) + p for p in stream] + [("tc",) + p for p in product],
        "qnn8": [("stream",) + p for p in stream] + [("tile",)],
        "bnn_bwd": [{"dx": p, "dw": (128, 1, 512)} for p in product],
    }[path]


@pytest.mark.parametrize("path", [p for p in autotune.PATH_KERNELS if p != "paged_attn"]
                         + ["paged_attn"])
def test_plan_error_and_contracts_read_one_geometry(path):
    """The plans the autotuner accepts (cache entries, overrides, search
    candidates) are exactly those the contracts find nothing in: both read
    kernels.geometry, so neither can drift from the other."""
    if path == "paged_attn":
        cases = [((4, 1, 15, 5, 64, 16, 8), [(q, s) for q in range(1, 34) for s in range(1, 18)]),
                 ((1, 32, 64, 8, 128, 16, 40), [(q, s) for q in (1, 2, 4, 8, 16, 32, 33)
                                                for s in range(1, 18)])]
    else:
        cases = [(shape, _broad_plans(path, *shape))
                 for shape in ((4, 960, 2560), (512, 968, 65), (37, 100, 130))]
    accepted = refused = 0
    for shape, plans in cases:
        for plan in plans:
            ok = autotune.plan_error(path, shape, plan) is None
            assert ok == (kc.check_plan(path, shape, plan)[0] == []), (shape, plan)
            accepted, refused = accepted + ok, refused + (not ok)
    assert accepted and refused


def test_build_keeps_each_sources_ptxas_log(tmp_path, monkeypatch):
    """A second build in the same checkout compiles nothing and still
    returns every source's -Xptxas -v output (kept beside its library); a
    library whose log is gone is built again."""
    from repro_torch.kernels import build

    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("alpha", "beta"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    nvcc = tmp_path / "nvcc"
    calls = tmp_path / "calls"
    nvcc.write_text("#!/bin/sh\n"
                    f"echo \"$@\" >> {calls}\n"
                    "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && touch \"$2\"; shift; done\n"
                    "echo \"ptxas info    : Used 40 registers, used 0 barriers\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "CSRC", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(out))
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    first, second = {}, {}
    paths = build.build_all(("alpha", "beta"), logs=first)
    assert sorted(first) == ["alpha", "beta"] and all("Used 40 registers" in v
                                                      for v in first.values())
    assert all("-Xptxas=-v" in line for line in calls.read_text().splitlines())
    assert build.build_all(("alpha", "beta"), logs=second) == paths and second == first
    assert len(calls.read_text().splitlines()) == 2  # nothing compiled the second time
    os.remove(paths["beta"][:-len(".so")] + ".ptxas.log")
    third = {}
    build.build_all(("alpha", "beta"), logs=third)
    assert third == first and len(calls.read_text().splitlines()) == 3


def test_chip_smoke_tooling_refuses_a_missing_ptxas_log():
    import sys

    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    with pytest.raises(SystemExit) as got:
        chip_smoke.phase_tooling(torch, None, torch.device("cpu"), {"cac_matmul": "x"})
    assert got.value.code == 1


def test_meta_evaluation_of_every_route():
    cfg = get_config("smollm-360m")
    for route in ops.KERNEL_ROUTES:
        assert kc._meta_eval(route, 4, 960, 2560, cfg) is None, route


def test_backend_keys_agree_with_routes():
    assert kc._registry_findings() == []
    from repro_torch.core.backend import LinearSpec, get_backend

    assert get_backend("bika").autotune_key(LinearSpec(mode="bika"), "serve", 4, 960, 2560,
                                            "cuda") == "cuda:hw_fwd:4x960x2560"
    assert get_backend("bnn").autotune_path(LinearSpec(mode="bnn", pack_signs=True),
                                            "serve") == "bnn_packed"
    assert get_backend("dense").autotune_key(LinearSpec(mode="dense"), "train", 1, 2, 3) is None


# ---------------------------------------------------------------------------
# Autotune
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", [p for p in autotune.PATH_KERNELS if p != "paged_attn"])
def test_cache_keys_round_trip(path):
    key = autotune.cache_key(path, 4, 960, 2560, "cuda")
    assert key == f"cuda:{path}:4x960x2560"
    assert autotune.parse_cache_key(key) == {"backend": "cuda", "path": path,
                                             "shape": (4, 960, 2560)}
    shape = (4, 1, 15, 5, 64, 16, 8)
    pkey = autotune.paged_attn_cache_key(*shape, backend="cpu")
    assert pkey == "cpu:paged_attn:4x128x16x64x5x1x15"
    assert autotune.parse_cache_key(pkey)["shape"] == shape
    assert autotune.parse_cache_key("cuda:nope:1x2x3") is None


def _plan_functions(path, m, k, n, w_dtype):
    return {
        "hw_fwd": lambda: cac.stream_plan(m, k, n),
        "train_fwd": lambda: cac.train_fwd_plan(m, k, n),
        "train_bwd": lambda: cac.train_bwd_plan(m, k, n),
        "train_bwd_dw": lambda: cac.train_bwd_dw_plan(m, k, n),
        "bnn": lambda: bnn.fwd_plan(m, k, n, w_dtype),
        "bnn_packed": lambda: cac.stream_plan(m, k, n, mt=bnn.PACKED_MT),
        "qnn8": lambda: qnn.qnn_plan(m, k, n),
    }[path]()


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_get_plan_without_cache_is_todays_plan(tune_cache, arch):
    cfg = get_config(arch)
    for route, info in kc.ROUTE_INFO.items():
        w_dtype = getattr(torch, info.get("w_dtype", "float32"))
        if route == "paged_attn":
            for shape in kc._paged_cases(cfg).values():
                assert autotune.get_paged_plan(*shape) == pa.attn_plan(*shape)
            continue
        for _, m in kc.M_CASES:
            for k, n in kc.config_gemms(cfg).values():
                for path in info["paths"]:
                    if path == "bnn_bwd":
                        for dx in (True, False):
                            assert autotune.get_plan(path, m, k, n, want_dx=dx) == bnn.bwd_plan(
                                m, k, n, dx)
                        continue
                    got = autotune.get_plan(path, m, k, n, w_dtype=w_dtype)
                    assert got == _plan_functions(path, m, k, n, w_dtype), (route, path, m, k, n)
    assert not tune_cache.exists()


def test_cache_entry_then_override_win(tune_cache):
    shape = (4, 960, 2560)
    default = autotune.get_plan("hw_fwd", *shape)
    tuned = (4, 4, 30)
    assert default != tuned
    autotune._store_cache(autotune.cache_key("hw_fwd", *shape, "cpu"),
                          autotune.plan_to_fields("hw_fwd", tuned))
    stored = json.loads(tune_cache.read_text())
    assert stored == {"cpu:hw_fwd:4x960x2560": {"mt": 4, "per": 30, "splits": 4}}
    assert tune_cache.read_text() == json.dumps(stored, indent=1, sort_keys=True)
    autotune.clear_cache()
    assert autotune.get_plan("hw_fwd", *shape) == tuned  # read back from the file
    assert autotune.get_plan("hw_fwd", *shape, overrides=(8, 1, 120)) == (8, 1, 120)
    assert autotune.get_plan("hw_fwd", *shape, overrides={"mt": 4, "splits": 2,
                                                          "per": 60}) == (4, 2, 60)
    with pytest.raises(ValueError):  # an override the launcher would refuse
        autotune.get_plan("hw_fwd", *shape, overrides=(4, 7, 20))
    # a forced route passes over a cached plan of the other route
    autotune._store_cache(autotune.cache_key("bnn", *shape, "cpu"),
                          {"route": "stream", "mt": 4, "splits": 2, "per": 60})
    assert autotune.get_plan("bnn", *shape) == ("stream", 4, 2, 60)
    assert autotune.get_plan("bnn", *shape, route="tc")[0] == "tc"
    # kernels 3 and 5 share the train_bwd entry; the card's key is not the CPU's
    autotune._store_cache(autotune.cache_key("train_bwd", 512, 960, 2560, "cuda"),
                          {"cluster": 5})
    assert autotune.get_plan("train_bwd", 512, 960, 2560) == cac.train_bwd_plan(512, 960, 2560)


def test_bad_cache_entries_are_rejected_and_reported(tune_cache):
    good = autotune.cache_key("train_fwd", 512, 960, 2560, "cuda")
    bad = {
        good: {"splits": 4, "per": 15},
        "garbage-key": {"splits": 1},
        autotune.cache_key("train_fwd", 512, 960, 960, "cuda"): {"splits": -3, "per": 1},
        autotune.cache_key("hw_fwd", 4, 960, 960, "cuda"): {"block_m": 8},
        autotune.cache_key("hw_fwd", 4, 960, 2560, "cuda"): {"mt": 4, "splits": 7, "per": 20},
        autotune.cache_key("train_bwd", 512, 960, 2560, "cuda"): {"cluster": 17},
        "cuda:paged_attn:4x128x16x64x5x1x15": {"q_tile": 1, "splits": 9},
    }
    tune_cache.write_text(json.dumps(bad, sort_keys=True))
    autotune.clear_cache()
    invalid = dict(autotune.invalid_cache_entries())
    assert good not in invalid and len(invalid) == 6
    assert "unparseable" in invalid["garbage-key"]
    assert "positive int" in invalid[autotune.cache_key("train_fwd", 512, 960, 960, "cuda")]
    assert "plan fields" in invalid[autotune.cache_key("hw_fwd", 4, 960, 960, "cuda")]
    # the cache's reason is the contracts' finding: one geometry serves both
    reason = invalid[autotune.cache_key("hw_fwd", 4, 960, 2560, "cuda")]
    assert "cover" in reason and "exactly once" in reason
    assert kc.check_plan("hw_fwd", (4, 960, 2560), (4, 7, 20))[0][0].message in reason
    assert "illegal" in invalid["cuda:paged_attn:4x128x16x64x5x1x15"]
    findings = kc._cache_findings()
    assert len(findings) == 6 and {f.code for f in findings} == {"KCV007"}
    # the reference's cache file is another file
    assert os.path.basename(autotune.cache_path()) == "autotune_torch.json"


def test_default_cache_path(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    assert autotune.cache_path() == os.path.join(
        os.path.expanduser("~"), ".cache", "repro", "autotune_torch.json")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_exit_codes(tmp_path, tune_cache):
    out = tmp_path / "analysis.json"
    assert analysis_main(["--lints", "--root", ROOT, "--quiet", "--paths",
                          _fixture("rpa001_ok.py"), "--json", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] and rep["passes"] == ["lints"]
    for code in ("rpa001", "rpa002", "rpa004", "rpa005"):
        assert analysis_main(["--lints", "--root", ROOT, "--quiet", "--paths",
                              _fixture(f"{code}_bad.py"), "--json", str(out)]) == 1
        rep = json.loads(out.read_text())
        assert {f["code"] for f in rep["findings"]} == {code.upper()}
    bad_log = tmp_path / "ptxas.log"
    with open(PTXAS_LOG, encoding="utf-8") as fh:
        bad_log.write_text(fh.read().replace("Used 255 registers", "Used 256 registers"))
    assert analysis_main(["--contracts", "--quiet", "--ptxas-log", str(bad_log),
                          "--json", str(out)]) == 1
    rep = json.loads(out.read_text())
    assert {f["code"] for f in rep["findings"]} == {"KCV004"}


def test_cli_all_is_clean_on_the_tree(tmp_path, tune_cache, monkeypatch):
    monkeypatch.chdir(ROOT)
    out = tmp_path / "analysis.json"
    assert analysis_main(["--all", "--quiet", "--json", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] and rep["passes"] == ["lints", "kernel_contracts"]

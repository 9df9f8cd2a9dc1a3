"""PyTorch port vs the JAX reference: serving observability on the CPU.

- the tracer: the same calls under a fake clock give equal records, equal
  JSONL and equal Perfetto JSON, byte for byte (ring eviction included);
- the metrics registry: the same operations give byte-equal Prometheus
  text and equal JSON snapshots; ``RunMetrics.bind_registry`` feeds the
  same counter, histogram and gauge names as the reference's;
- the step timer samples and accounts as the reference's does, and its
  ``sync`` is a no-op on the CPU;
- a smoke-size paged and continuous drain: the trace reconciles with its
  ``RunMetrics`` exactly, passes the reference's own trace validator, and
  carries the same event and span names, counted per track, as the
  reference's traced drain of the same requests on the same weights;
- the disabled path records nothing; ``replay_arrivals`` with an injected
  clock and sleep gives the closed-loop tokens;
- the launcher's observability flags run under ``--device cpu --smoke``.
"""
import collections
import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import build_model as jax_build_model
from repro.nn.module import unbox
from repro.obs import profile as jprofile
from repro.obs import registry as jregistry
from repro.obs import trace as jtrace
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.metrics import RequestMetrics as JaxRequestMetrics
from repro.serve.metrics import RunMetrics as JaxRunMetrics
from repro_torch.core.convert import from_reference
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models.base import ArchConfig
from repro_torch.obs import profile as tprofile
from repro_torch.obs import registry as tregistry
from repro_torch.obs import trace as ttrace
from repro_torch.obs.registry import parse_prometheus
from repro_torch.serve import Request, ServeEngine, replay_arrivals
from repro_torch.serve.metrics import RequestMetrics, RunMetrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the tier-1 run
    holds several test processes at once, and torch's default of a thread
    a core in each of them oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FakeClock:
    """Deterministic clock: each call advances by ``step``."""

    def __init__(self, start: float = 100.0, step: float = 0.25):
        self.t = start
        self.step = step

    def __call__(self) -> float:
        t, self.t = self.t, self.t + self.step
        return t


def _drive_tracer(mod, capacity):
    tr = mod.Tracer(clock=FakeClock(), capacity=capacity)
    tr.event("submit", track="scheduler", rid=0, prompt_len=5)
    with tr.span("compile", "scheduler", kind="decode_tick", n_slots=2):
        pass
    tr.add_span("queued", "requests", 100.5, 101.0, async_id=0, rid=0)
    tr.add_span("prefill", "slot1", 101.0, 101.75, rid=0, prompt_len=5, cached_tokens=0)
    tr.event("prefix_hit", track="scheduler", rid=1, prompt_len=19, cached_tokens=16)
    tr.add_span("prefill_chunk", "slot0", 101.5, 101.625, rid=1, chunk=0, start=16, end=19)
    tr.event("prefix_eviction", block=3, blocks_cached=1)
    tr.add_span("decode", "slot1", 101.75, 103.0, rid=0, n_tokens=4, tpot_s=1.25 / 3)
    tr.add_span("request", "requests", 100.5, 103.0, async_id=0, rid=0, ttft_s=1.25)
    tr.add_span("admit", "profiler", 102.0, 102.125, tick=3)
    tr.add_span("backwards", "scheduler", 10.0, 9.0)  # clamps to 0
    return tr


@pytest.mark.parametrize("capacity", [65536, 4])
def test_tracer_records_jsonl_and_perfetto_equal_reference(tmp_path, capacity):
    got, want = _drive_tracer(ttrace, capacity), _drive_tracer(jtrace, capacity)
    assert [r.to_json() for r in got.records] == [r.to_json() for r in want.records]
    assert got.dropped == want.dropped == (7 if capacity == 4 else 0)
    assert got.header() == want.header()
    summary = {"goodput_tok_s": 5.0, "completed_requests": 1}
    requests = [{"rid": 0, "ttft_s": 1.25}]
    for tr, name in ((got, "port"), (want, "ref")):
        tr.write_jsonl(str(tmp_path / f"{name}.jsonl"), summary=summary, requests=requests)
        tr.write_perfetto(str(tmp_path / f"{name}.perfetto.json"))
    for suffix in (".jsonl", ".perfetto.json"):
        assert (tmp_path / f"port{suffix}").read_bytes() == (tmp_path / f"ref{suffix}").read_bytes()
    assert ttrace.TRACE_SCHEMA_VERSION == jtrace.TRACE_SCHEMA_VERSION
    recs = [r.to_json() for r in got.records] + [{"kind": "meta"}]
    assert ttrace.records_to_perfetto(recs) == jtrace.records_to_perfetto(recs)


def test_null_tracer_and_global_hook():
    null = ttrace.NULL_TRACER
    assert null.enabled is False and null.event("x", rid=1) is None
    assert null.add_span("x", "t", 0.0, 1.0) is None
    assert null.span("a") is null.span("b")
    with null.span("x"):
        pass
    assert len(null) == 0 and null.records == []
    assert ttrace.get_tracer() is null
    tr = ttrace.Tracer(clock=FakeClock())
    assert ttrace.set_tracer(tr) is null
    try:
        assert ttrace.get_tracer() is tr
    finally:
        ttrace.set_tracer(None)
    assert ttrace.get_tracer() is null
    with pytest.raises(ValueError):
        ttrace.Tracer(capacity=0)


def _drive_registry(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("serve_requests_total", "completed requests", ["mode"])
    c.inc(mode="bika")
    c.inc(2.0, mode="bnn")
    g = reg.gauge("serve_run_goodput_tok_s", "goodput", ["engine"])
    g.set(12.5, engine="paged")
    g.inc(0.25, engine="paged")
    h = reg.histogram("lat_seconds", "latency", ["m"], buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v, m='a"b\\c')
    reg.histogram("default_seconds").observe(0.003)
    errors = []
    for bad in (lambda: reg.gauge("serve_requests_total"),
                lambda: reg.counter("serve_requests_total", "", ["x"]),
                lambda: reg.counter("bad name"), lambda: c.inc(-1.0, mode="bika"),
                lambda: c.inc(1.0)):
        with pytest.raises(ValueError) as e:
            bad()
        errors.append(str(e.value))
    return reg, errors


def test_registry_prometheus_and_snapshot_equal_reference(tmp_path):
    (got, gerr), (want, werr) = _drive_registry(tregistry), _drive_registry(jregistry)
    assert got.to_prometheus() == want.to_prometheus()
    assert got.snapshot() == want.snapshot()
    assert gerr == werr
    assert tregistry.DEFAULT_BUCKETS == jregistry.DEFAULT_BUCKETS
    got.write_json(str(tmp_path / "p.json"))
    want.write_json(str(tmp_path / "r.json"))
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "r.json").read_bytes()
    parsed = parse_prometheus(got.to_prometheus())
    assert parsed[("serve_requests_total", (("mode", "bnn"),))] == 2.0
    assert parsed[("lat_seconds_bucket", (("m", 'a\\"b\\\\c'), ("le", "+Inf")))] == 5.0
    with pytest.raises(ValueError):
        parse_prometheus("orphan_total 1\n")
    with pytest.raises(ValueError):
        parse_prometheus("# TYPE x counter\nx{a=1} 2\n")


def _finished(mod, rid, t0, tpot):
    rm = mod(rid=rid, prompt_len=4, t_submit=t0)
    rm.t_admit = t0 + 1.0
    rm.t_first_token = rm.t_admit + 0.5
    rm.t_done = rm.t_first_token + tpot * 4
    rm.n_tokens = 5
    return rm


def test_run_metrics_feed_the_reference_names():
    """``bind_registry`` feeds the reference's counters, histograms and
    ``serve_run_*`` gauges: the same requests give byte-equal text."""
    texts = []
    for run_cls, rm_cls, reg_mod in ((RunMetrics, RequestMetrics, tregistry),
                                    (JaxRunMetrics, JaxRequestMetrics, jregistry)):
        reg = reg_mod.MetricsRegistry()
        lb = dict(mode="bika", engine="paged", route="fused")
        run = run_cls(n_slots=2).bind_registry(reg, **lb)
        for i, tpot in enumerate((0.1, 0.2, 0.3, 10.0)):
            run.finish_request(_finished(rm_cls, i, float(i), tpot))
        run.record_step(2, kv_bytes_read=1024)
        run.t_start, run.t_end = 0.0, 10.0
        run.publish()
        texts.append(reg.to_prometheus())
    assert texts[0] == texts[1]
    names = {k[0] for k in parse_prometheus(texts[0])}
    assert {"serve_requests_total", "serve_tokens_total", "serve_ttft_seconds_count",
            "serve_run_goodput_tok_s"} <= names


def _drive_timer(mod, tracer_mod):
    tr = tracer_mod.Tracer(clock=FakeClock()) if tracer_mod else None
    clock = None if tr is not None else FakeClock(step=1.0)
    st = mod.StepTimer(sample_every=3, clock=clock, tracer=tr)
    for _ in range(7):  # ticks 0, 3 and 6 sample
        st.tick()
        with st.phase("admit"):
            pass
        with st.phase("decode"):
            st.sync(np.zeros(2))
        with st.phase("host"):
            pass
    return st, tr


@pytest.mark.parametrize("traced", [False, True])
def test_step_timer_samples_and_accounts_as_reference(traced):
    got, gtr = _drive_timer(tprofile, ttrace if traced else None)
    want, wtr = _drive_timer(jprofile, jtrace if traced else None)
    assert got.summary() == want.summary()
    assert got.summary()["sampled_ticks"] == 3 and got.summary()["ticks"] == 7
    if traced:
        assert got.clock is gtr.clock
        assert [r.to_json() for r in gtr.records] == [r.to_json() for r in wtr.records]
    got.sampling = False
    assert got.phase("admit") is got.phase("decode")
    with pytest.raises(ValueError):
        tprofile.StepTimer(sample_every=0)


def test_null_timer_and_profile_window(tmp_path):
    null = tprofile.NULL_TIMER
    assert null.enabled is False and null.tick() is False
    assert null.phase("a") is null.phase("b") and null.sync("x") == "x"
    st = tprofile.StepTimer(1)
    st.tick()
    x = torch.ones(3)
    assert st.sync(x) is x and st.sync((x, np.ones(1))) is not None  # CPU: no wait
    with tprofile.profile_trace(""):
        pass
    with tprofile.profile_trace(None):
        pass
    window = tprofile.profile_trace(str(tmp_path / "prof"))
    with window:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    with open(window.path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


# ---------------------------------------------------------------------------
# traced drains, port against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_get_smoke("smollm-360m", compute_mode="dense", remat=False)
    np_params = jax.tree_util.tree_map(
        np.asarray, unbox(jax_build_model(jcfg, phase="train").init(jax.random.PRNGKey(7))))
    cfg = ArchConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ArchConfig)})
    return jcfg, np_params, cfg


def _prompts(vocab):
    """A 20-token prompt (3 blocks of 8 with its tokens: the next request
    defers on a 4-block pool), one sharing its first two blocks (a prefix
    hit), and short ones; later admissions evict cached blocks."""
    rng = np.random.RandomState(0)
    first = rng.randint(0, vocab, 20).astype(np.int32)
    out = [first, rng.randint(0, vocab, 6).astype(np.int32),
           np.concatenate([first[:16], rng.randint(0, vocab, 3).astype(np.int32)])]
    out += [rng.randint(0, vocab, n).astype(np.int32) for n in (5, 9, 4)]
    return out


ENGINE_KW = dict(n_slots=2, max_len=32, kv_block_size=8, prefill_chunk=8, profile_sample=2)


def _port_drain(cfg, np_params, engine, tracer, registry, **kw):
    eng = ServeEngine(build_model(cfg, phase="serve"), from_reference(np_params), cfg,
                      engine=engine, tracer=tracer, registry=registry, device="cpu",
                      **dict(ENGINE_KW, **kw))
    for i, p in enumerate(_prompts(cfg.vocab)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=4))
    return eng, eng.run()


def _counts(records):
    return collections.Counter((r.kind, r.name, r.track) for r in records)


@pytest.mark.parametrize("engine", ["continuous", "paged"])
def test_traced_drain_reconciles_and_matches_reference_counts(lm, engine, tmp_path):
    jcfg, np_params, cfg = lm
    pool = {"kv_n_blocks": 4} if engine == "paged" else {}
    tracer, reg = ttrace.Tracer(), tregistry.MetricsRegistry()
    eng, done = _port_drain(cfg, np_params, engine, tracer, reg, **pool)
    assert len(done) == 6
    spans = collections.defaultdict(dict)
    for r in tracer.records:
        if r.kind == "span" and r.name in ("queued", "prefill", "decode") and \
                r.track != "profiler":  # the step timer's decode phase is no request span
            assert r.name not in spans[r.args["rid"]]  # one of each a request
            spans[r.args["rid"]][r.name] = r
    assert sorted(spans) == list(range(6))
    for r in done:  # the same clock reads: exact, not approximate
        rm, sp = r.metrics, spans[r.rid]
        assert sp["queued"].ts == rm.t_submit and sp["queued"].dur == rm.queue_wait
        assert sp["prefill"].ts == rm.t_admit and sp["prefill"].dur == rm.prefill_latency
        assert sp["decode"].ts == rm.t_first_token
        assert sp["decode"].dur == rm.t_done - rm.t_first_token
        assert sp["prefill"].track == sp["decode"].track
    s = eng.metrics.summary()
    if engine == "paged":
        assert s["admission_deferrals"] > 0 and s["prefix_hit_tokens"] == 16
        assert s["prefix_evictions"] > 0
    labels = dict(mode="dense", engine=engine, route=cfg.paged_attn_route)
    assert reg.get("serve_requests_total").value(**labels) == 6
    assert reg.get("serve_run_completed_requests").value(**labels) == 6
    assert set(eng.profiler.summary()["phases"]) == {"admit", "decode", "host"}
    # the reference's validator accepts the port's JSONL
    path = str(tmp_path / "trace.jsonl")
    tracer.write_jsonl(path, summary=s, requests=[r.metrics.to_dict() for r in done])
    sys.path.insert(0, ROOT)
    try:
        from benchmarks.trace_report import load, validate
    finally:
        sys.path.pop(0)
    assert validate(load(path), tol=1e-6) == []
    # the reference's traced drain of the same requests on the same weights
    jtr = jtrace.Tracer()
    jeng = JaxServeEngine(jax_build_model(jcfg, phase="train"), np_params, jcfg,
                          engine=engine, tracer=jtr, registry=jregistry.MetricsRegistry(),
                          **dict(ENGINE_KW, **pool))
    for i, p in enumerate(_prompts(jcfg.vocab)):
        jeng.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=4))
    jdone = jeng.run()
    assert ({r.rid: list(r.output) for r in done}
            == {r.rid: [int(t) for t in r.output] for r in jdone})
    assert _counts(tracer.records) == _counts(jtr.records)
    assert eng.profiler.summary()["ticks"] == jeng.profiler.summary()["ticks"]


def test_disabled_path_emits_nothing(lm):
    _, np_params, cfg = lm
    eng = ServeEngine(build_model(cfg, phase="serve"), from_reference(np_params), cfg,
                      engine="paged", n_slots=2, max_len=32, kv_block_size=8,
                      prefill_chunk=8, device="cpu")
    assert eng.scheduler.tracer is ttrace.NULL_TRACER
    assert eng.scheduler.profiler is tprofile.NULL_TIMER and eng.profiler is None
    eng.submit(Request(rid=0, prompt=np.arange(1, 5, dtype=np.int32), max_new_tokens=2))
    assert len(eng.run()) == 1
    assert len(ttrace.NULL_TRACER) == 0 and tprofile.NULL_TIMER.ticks == 0


@pytest.mark.parametrize("engine", ["continuous", "paged"])
def test_replay_arrivals_gives_the_closed_loop_tokens(lm, engine):
    _, np_params, cfg = lm
    _, closed = _port_drain(cfg, np_params, engine, None, None)
    eng = ServeEngine(build_model(cfg, phase="serve"), from_reference(np_params), cfg,
                      engine=engine, device="cpu", **ENGINE_KW)
    clock = FakeClock(start=0.0, step=0.001)
    eng.scheduler.clock = clock
    slept = []

    def sleep(dt):
        slept.append(dt)
        clock.t += dt

    reqs = [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(_prompts(cfg.vocab))]
    arrivals = [0.0, 0.0, 0.5, 0.5, 2.0, 2.01]  # idle gaps: the loop sleeps
    stamped = []

    def submit(req, t_abs):
        stamped.append((req.rid, t_abs))
        eng.scheduler.submit(req)

    done, makespan = replay_arrivals(eng.scheduler, list(zip(arrivals, reqs)), submit=submit,
                                     sleep=sleep)
    assert {r.rid: list(r.output) for r in done} == {r.rid: list(r.output) for r in closed}
    assert slept and all(dt >= 0 for dt in slept)
    assert [rid for rid, _ in stamped] == list(range(6))
    assert [t for _, t in stamped] == arrivals  # t0 = 0.0 on the fake clock
    assert makespan >= 2.01 and eng.metrics.t_end - eng.metrics.t_start == makespan
    for r in done:
        assert r.metrics.t_submit >= arrivals[r.rid]


@pytest.mark.parametrize("engine,rate", [("paged", 50.0), ("continuous", 0.0)])
def test_launcher_observability_flags_on_cpu(tmp_path, capsys, engine, rate):
    trace = str(tmp_path / "t.jsonl")
    prom = str(tmp_path / ("m.prom" if engine == "paged" else "m.json"))
    prof = str(tmp_path / "prof")
    assert launch_serve.main([
        "--smoke", "--device", "cpu", "--engine", engine, "--requests", "5", "--new-tokens",
        "4", "--max-len", "64", "--kv-block-size", "8", "--prefill-chunk", "16",
        "--trace-out", trace, "--trace-capacity", "4096", "--metrics-out", prom,
        "--profile-sample", "2", "--arrival-rate", str(rate), "--profile-dir", prof]) == 0
    out = capsys.readouterr().out
    assert "[serve] completed 5 requests" in out and "[serve] profile: " in out
    assert f"-> {trace}" in out and f"metrics -> {prom}" in out
    assert ttrace.get_tracer() is ttrace.NULL_TRACER  # the launcher restored the hook
    lines = [json.loads(ln) for ln in open(trace)]
    assert lines[0]["kind"] == "meta" and lines[-1]["footer"]
    assert len(lines[-1]["requests"]) == 5
    with open(trace[:-6] + ".perfetto.json") as fh:
        assert json.load(fh)["traceEvents"]
    if prom.endswith(".prom"):
        samples = parse_prometheus(open(prom).read())
        assert samples[("serve_requests_total", (("engine", engine), ("mode", "bika"),
                                                 ("route", "fused")))] == 5.0
    else:
        assert json.load(open(prom))["serve_requests_total"]["type"] == "counter"
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")

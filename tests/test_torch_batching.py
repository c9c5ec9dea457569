"""The port's batched dispatch (``run_many``, ``chunk_plan``), row slab and
input cache, held against the JAX engine on the same tiny weights, feature
files and requests, on the CPU.

Both engines use image buckets (1, 2, 4) and one throughput bucket (8); the
JAX one runs dense attention, the port its kernel routes (the plain version
on the CPU). Tolerance: f32 engines decode the same answers in the same
order, scores and confidences within 2e-5 (absolute and relative: f32
summation order, batch rows computed in another grouping).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (
    assert_same_result,
    engine_pair,
    write_feature_files,
)
from vilbert_multitask_tpu.config import (
    EngineConfig,
    FrameworkConfig,
    ServingConfig,
    ViLBertConfig,
)
from vilbert_multitask_tpu_torch import config as port_config
from vilbert_multitask_tpu_torch.engine import runtime as port_runtime
from vilbert_multitask_tpu_torch.ops import routes
from vilbert_multitask_tpu_torch.resilience import (
    Deadline,
    DeadlineExceeded,
    ReplicaKilled,
)

F32 = dict(rtol=2e-5, atol=2e-5)
IMAGES = tuple(f"img_{i}" for i in range(6))
JAX_CFG = FrameworkConfig(
    model=ViLBertConfig().tiny(),
    engine=EngineConfig(
        max_text_len=12, max_regions=9, num_features=8,
        image_buckets=(1, 2, 4), throughput_buckets=(8,),
        compute_dtype="float32", device_input_cache_entries=8,
        use_pallas_coattention=False, use_pallas_self_attention=False))
# (task id, question) per decode family.
FAMILIES = {
    "labels": [(1, "what is the man holding"),
               (15, "is the bowl right of the mug")],
    "binary": [(12, "both images contain two wolves")],
    "trinary": [(13, "two dogs are playing in the snow")],
    "ranking": [(7, "a man riding a horse on the beach")],
    "grounding": [(4, "which object can you eat"),
                  (11, "the woman in the red coat"),
                  (16, "q: is it a person? a: no")],
}


def _images_for(task_id: int, k: int) -> list:
    """Images of the k-th request of a task: NLVR2 takes a pair, retrieval
    2-4 candidates, the rest one image."""
    n = {12: 2, 7: 2 + k % 3}.get(task_id, 1)
    return [IMAGES[(k + j) % len(IMAGES)] for j in range(n)]


@pytest.fixture(scope="module")
def feature_root(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_batching_features")
    write_feature_files(str(d), JAX_CFG.model.v_feature_size, IMAGES)
    return str(d)


@pytest.fixture(scope="module")
def world(feature_root):
    jeng, peng, sd = engine_pair(JAX_CFG, feature_root)
    return dict(jax=jeng, port=peng, sd=sd)


def _requests(eng, specs):
    return [eng.prepare_from_store(t, q, imgs) for t, q, imgs in specs]


def _run_many_both(world, specs, **kw):
    want = world["jax"].run_many(_requests(world["jax"], specs), **kw)
    got = world["port"].run_many(_requests(world["port"], specs), **kw)
    assert len(got) == len(want) == len(specs)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same_result(g.to_json(), w.to_json(), F32, f"request {i}")
    return got


# ----------------------------------------------------------------- config
@pytest.mark.parametrize("engine", [
    dict(),
    dict(throughput_buckets=None),
    dict(image_buckets=(1, 2, 4, 8, 10), throughput_buckets=(16, 32, 64)),
    dict(image_buckets=(1, 3), throughput_buckets=(2, 12)),
], ids=["default", "no_throughput", "wide", "odd"])
def test_row_buckets_match_jax(engine):
    jcfg = EngineConfig(**engine)
    pcfg = port_config.EngineConfig(**engine)
    assert pcfg.all_row_buckets() == jcfg.all_row_buckets()
    assert pcfg.max_batch_rows() == jcfg.max_batch_rows()
    for n in range(1, jcfg.max_batch_rows() + 1):
        assert pcfg.row_bucket_for(n) == jcfg.row_bucket_for(n)
    for bad in (0, jcfg.max_batch_rows() + 1):
        with pytest.raises(ValueError):
            pcfg.row_bucket_for(bad)


def test_serving_config_is_a_full_copy_of_jax():
    """Same fields, same defaults, same order."""
    assert (dataclasses.asdict(port_config.ServingConfig())
            == dataclasses.asdict(ServingConfig()))
    assert ([f.name for f in dataclasses.fields(port_config.ServingConfig)]
            == [f.name for f in dataclasses.fields(ServingConfig)])


def test_engine_defaults_match_jax():
    jax_defaults = dataclasses.asdict(EngineConfig())
    for name, value in dataclasses.asdict(port_config.EngineConfig()).items():
        assert value == jax_defaults[name], name
    assert port_config.EngineConfig().throughput_buckets == (16, 32)
    assert port_config.EngineConfig().device_input_cache_entries == 64


def test_from_dict_carries_the_jax_config():
    jcfg = dataclasses.replace(JAX_CFG, serving=ServingConfig(
        http_port=0, sched_window_max_s=0.01, tenant_weights={"a": 2.0},
        pool_replicas=3))
    pcfg = port_config.FrameworkConfig.from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(pcfg.serving) == dataclasses.asdict(
        jcfg.serving)
    jeng = dataclasses.asdict(jcfg.engine)
    for name, value in dataclasses.asdict(pcfg.engine).items():
        want = jeng[name]
        assert value == (tuple(want) if isinstance(want, list) else want)
    assert pcfg.engine.all_row_buckets() == [1, 2, 4, 8]


# --------------------------------------------------------------- packing
@pytest.mark.parametrize("seed", range(6))
def test_chunk_plan_matches_jax(world, seed):
    rng = np.random.default_rng(seed)
    counts = [int(c) for c in rng.integers(1, 5, size=rng.integers(1, 24))]
    for chunk_rows in (None, 4, 8):
        want = world["jax"].chunk_plan(counts, chunk_rows=chunk_rows)
        assert world["port"].chunk_plan(counts, chunk_rows=chunk_rows) \
            == want
        assert world["port"].padded_rows(counts, chunk_rows=chunk_rows) \
            == world["jax"].padded_rows(counts, chunk_rows=chunk_rows)
    for bad in (dict(chunk_rows=3), dict(chunk_rows=0)):
        with pytest.raises(ValueError):
            world["port"].chunk_plan(counts, **bad)
    with pytest.raises(ValueError, match="exceeds"):
        world["port"].chunk_plan(counts + [5], chunk_rows=4)


# ---------------------------------------------------------------- run_many
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_run_many_matches_jax_per_family(world, family):
    specs = [(t, f"{q} {k}", _images_for(t, k))
             for k in range(4) for t, q in FAMILIES[family]]
    _run_many_both(world, specs)


def test_run_many_mixed_chunks_match_jax(world):
    """Mixed families in shared chunks: NLVR2 pairs after odd counts in
    request order (chunk_plan moves even counts first), retrieval of 3
    candidates, chunks of 8 rows and of 4."""
    specs = [(1, "what color", ["img_0"]),
             (12, "two wolves", ["img_1", "img_2"]),
             (7, "a horse", ["img_3", "img_4", "img_5"]),
             (13, "dogs", ["img_2"]),
             (12, "a cat", ["img_5", "img_0"]),
             (11, "the woman", ["img_4"]),
             (7, "a beach", ["img_1", "img_3"]),
             (15, "the bowl", ["img_3"])]
    for chunk_rows in (None, 4):
        _run_many_both(world, specs, chunk_rows=chunk_rows)


def test_run_many_matches_run(world):
    """Each member of a packed backlog decodes as it does alone."""
    eng = world["port"]
    specs = [(t, f"{q} {k}", _images_for(t, k)) for k in range(2)
             for fam in sorted(FAMILIES) for t, q in FAMILIES[fam][:1]]
    many = eng.run_many(_requests(eng, specs))
    for req, res in zip(_requests(eng, specs), many):
        assert_same_result(res.to_json(), eng.run(req)[1].to_json(), F32)


def test_on_result_streams_every_position_once(world):
    eng = world["port"]
    specs = [(t, q, _images_for(t, k)) for k in range(3)
             for t, q in FAMILIES["labels"] + FAMILIES["binary"]]
    seen = []
    out = eng.run_many(_requests(eng, specs), chunk_rows=4,
                       on_result=lambda pos, res: seen.append((pos, res)))
    assert sorted(pos for pos, _ in seen) == list(range(len(specs)))
    for pos, res in seen:
        assert res is out[pos]


def test_run_many_of_nothing_is_nothing(world):
    assert world["port"].run_many([]) == []


# ------------------------------------------------------ row slab and cache
def _cache_state(eng):
    return list(eng._input_cache.items()), eng.input_cache_stats


def test_slab_lru_sequence_matches_jax(feature_root):
    """A 3-entry cache walked through hits, misses and evictions by run()
    and run_many: the same LRU order, the same slots and the same
    input_cache_stats after every step, and the same answers."""
    cfg = dataclasses.replace(JAX_CFG, engine=dataclasses.replace(
        JAX_CFG.engine, device_input_cache_entries=3))
    jeng, peng, _ = engine_pair(cfg, feature_root)
    steps = [["img_0"], ["img_1"], ["img_2"], ["img_0"], ["img_3"],
             ["img_1"], ["img_3"], ["img_4"], ["img_0"]]
    for k, images in enumerate(steps):
        want = jeng.run(jeng.prepare_from_store(1, f"q {k}", images))[1]
        got = peng.run(peng.prepare_from_store(1, f"q {k}", images))[1]
        assert_same_result(got.to_json(), want.to_json(), F32, f"step {k}")
        assert _cache_state(peng) == _cache_state(jeng), f"step {k}"
    # One chunk with as many distinct images as the cache has entries (a
    # chunk with more is the case test_pack_with_more_keys_... covers,
    # where the JAX engine evicts a row its own chunk reads).
    batch = [(1, "a", ["img_5"]), (13, "b", ["img_0"]),
             (12, "c", ["img_0", "img_4"])]
    want = jeng.run_many(_requests(jeng, batch))
    got = peng.run_many(_requests(peng, batch))
    for g, w in zip(got, want):
        assert_same_result(g.to_json(), w.to_json(), F32)
    assert _cache_state(peng) == _cache_state(jeng)
    assert peng.input_cache_stats["hits"] >= 3


def _small_cache_engine(world, entries: int):
    cfg = dataclasses.replace(world["port"].cfg, engine=dataclasses.replace(
        world["port"].cfg.engine, device_input_cache_entries=entries))
    return port_runtime.InferenceEngine(
        cfg, params=world["sd"], feature_store=world["port"].feature_store,
        device="cpu")


def test_evicted_slot_overwrite_keeps_results(world):
    """A result does not change when its cache slot is evicted and written
    over by another image; asked again, the image misses and decodes the
    same, as in the JAX engine."""
    eng = _small_cache_engine(world, 2)
    req = eng.prepare_from_store(15, "the bowl", ["img_5"])
    first = eng.run(req)[1]
    slot = eng._input_cache[req.cache_keys[0]]
    before = eng._slab["features"][slot].clone()
    for name in ("img_0", "img_1"):  # img_1 takes img_5's slot
        eng.run(eng.prepare_from_store(1, "fill", [name]))
    assert req.cache_keys[0] not in eng._input_cache
    assert not torch.equal(eng._slab["features"][slot], before)
    again = eng.run(eng.prepare_from_store(15, "the bowl", ["img_5"]))[1]
    assert eng.input_cache_stats == {"entries": 2, "hits": 0, "misses": 4}
    assert again.to_json() == first.to_json()
    want = world["jax"].run(world["jax"].prepare_from_store(
        15, "the bowl", ["img_5"]))[1]
    assert_same_result(again.to_json(), want.to_json(), F32)


def test_pack_with_more_keys_than_cache_entries_keeps_every_row(world):
    """A 2-entry cache and one chunk of 5 distinct cached images: the rows
    that find every entry taken by their own pack go to scratch slots
    uncached, and each request decodes as it does alone."""
    eng = _small_cache_engine(world, 2)
    specs = [(1, f"q {i}", [IMAGES[i]]) for i in range(5)]
    many = eng.run_many(_requests(eng, specs))
    assert eng.input_cache_stats == {"entries": 2, "hits": 0, "misses": 5}
    for req, res in zip(_requests(eng, specs), many):
        assert_same_result(res.to_json(), eng.run(req)[1].to_json(), F32)


def test_live_stats_has_the_jax_keys(world):
    want = world["jax"].live_stats()
    got = world["port"].live_stats()
    assert set(got) == set(want)
    assert all(isinstance(v, float) for v in got.values())
    assert got["engine_slab_slots_total"] == \
        JAX_CFG.engine.device_input_cache_entries
    assert got["engine_compiled_programs"] == 0.0  # no graphs on the CPU
    assert set(world["port"].input_cache_stats) == {"entries", "hits",
                                                    "misses"}


# ------------------------------------------------------- resilience gates
@pytest.mark.parametrize("entry", ["run", "run_many"])
def test_expired_deadline_raises_before_any_forward(world, monkeypatch,
                                                    entry):
    eng = world["port"]
    req = eng.prepare_from_store(1, "late", ["img_0"])
    stats = eng.input_cache_stats

    def no_forward(*a, **k):
        raise AssertionError("a forward ran past an expired deadline")

    monkeypatch.setattr(eng, "_rows_step", no_forward)
    expired = Deadline(-1.0)
    with pytest.raises(DeadlineExceeded):
        if entry == "run":
            eng.run(req, deadline=expired)
        else:
            eng.run_many([req, req], deadline=expired)
    assert eng.input_cache_stats == stats  # nothing was packed either


def test_killed_engine_raises(world):
    eng = world["port"]
    req = eng.prepare_from_store(1, "dead", ["img_0"])
    eng.killed = True
    try:
        with pytest.raises(ReplicaKilled):
            eng.run(req)
        with pytest.raises(ReplicaKilled):
            eng.run_many([req])
    finally:
        eng.killed = False
    assert eng.run(req)[1].kind == "labels"
    assert eng.kernel_fallback is False


def test_cpu_warmup_runs_every_bucket_eagerly(world):
    eng = world["port"]
    assert eng.cfg.engine.all_row_buckets() == [1, 2, 4, 8]
    eng.warmup(parallel=True)
    assert eng._graphs == {} and eng.live_stats()[
        "engine_compiled_programs"] == 0.0


def test_bundle_flattening_round_trips():
    """The one-tensor bundle crosses back to the same leaves exactly, the
    paired NLVR2 head and the int64 top-k indices included."""
    rng = np.random.default_rng(0)
    rows = 4
    vals = torch.from_numpy(rng.random((rows, 3)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 3129, (rows, 3)))
    bundle = {
        "labels_top": {"vil_prediction": (vals, idx),
                       "vil_prediction_gqa": (vals * 2, idx + 1)},
        "vil_logit": torch.randn(rows, 1),
        "vil_tri_prediction": torch.randn(rows, 3),
        "vision_logit": torch.randn(rows, 9, 1),
        "vil_binary_prediction": torch.randn(rows // 2, 2),
    }
    flat, spec = port_runtime._flatten_bundle(bundle, rows)
    assert flat.shape == (rows, 3 * 4 + 1 + 3 + 9 + 1)
    back = port_runtime._unflatten_bundle(flat.numpy(), spec)
    assert set(back) == set(bundle)
    for name in ("vil_prediction", "vil_prediction_gqa"):
        p, i = back["labels_top"][name]
        wp, wi = bundle["labels_top"][name]
        np.testing.assert_array_equal(p, wp.numpy())
        assert i.dtype == np.int64
        np.testing.assert_array_equal(i, wi.numpy())
    for name in ("vil_logit", "vil_tri_prediction", "vision_logit",
                 "vil_binary_prediction"):
        np.testing.assert_array_equal(back[name], bundle[name].numpy())


@pytest.mark.parametrize("library", [lib.name for lib in routes.LIBRARIES])
def test_graph_capture_moves_launch_counts_to_replays(monkeypatch, library):
    """engine/graphs.py's bookkeeping for each declared kernel wrapper,
    with the CUDA graph API stubbed (there is no card here): capture runs
    in CUDA's thread_local mode, counts the launches its own thread
    records (a wrapper's count under capture, ``ops/routes.py:count``,
    tallies them in its thread-local ``recorded``), leaves the launches
    another thread makes meanwhile on the counter, each replay adds the
    recorded launches, and a failed capture raises with the counter
    untouched."""
    import contextlib
    import importlib
    import threading

    from vilbert_multitask_tpu_torch.engine import graphs

    entry = next(lib.entry for lib in routes.LIBRARIES if lib.name == library)
    module, name = entry.rsplit(".", 1)
    wrapper = getattr(importlib.import_module(
        f"vilbert_multitask_tpu_torch.{module}"), name)
    assert wrapper in routes.wrappers()

    class FakeGraph:
        replays = 0

        def replay(self):
            FakeGraph.replays += 1

    class FakeStream:
        def synchronize(self):
            pass

    modes = []
    capturing = threading.local()  # CUDA's thread_local capture: this thread

    @contextlib.contextmanager
    def fake_graph(graph, pool=None, stream=None,
                   capture_error_mode="global"):
        modes.append(capture_error_mode)
        capturing.on = True
        try:
            yield
        finally:
            capturing.on = False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_graph)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: getattr(capturing, "on", False))
    monkeypatch.setattr(wrapper, "launches", 5)
    monkeypatch.setattr(wrapper, "recorded", threading.local())

    def other_replica():
        # Another thread's dispatch during the capture: it launches (and
        # counts) for real, and its thread's tally is its own.
        routes.count(wrapper)
        routes.count(wrapper)
        wrapper.recorded.n = 7

    def step(pack):
        for _ in range(3):  # the wrapper's count while capturing
            routes.count(wrapper)
        t = threading.Thread(target=other_replica)
        t.start()
        t.join(timeout=10)
        return "out", pack * 2, ["spec"]

    g = graphs.capture(4, step, torch.ones(2), stream=FakeStream(),
                       pool=None)
    assert modes == ["thread_local"]
    assert wrapper.launches == 7
    assert g.launches == {wrapper: 3}
    assert g.bucket == 4 and g.spec == ["spec"] and g.flat.tolist() == [2, 2]
    g.replay()
    g.replay()
    assert FakeGraph.replays == 2 and wrapper.launches == 13

    def broken(pack):
        routes.count(wrapper)
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        graphs.capture(1, broken, torch.ones(1), stream=FakeStream(),
                       pool=None)
    assert wrapper.launches == 13


def test_concurrent_dispatches_keep_every_row(world):
    """Eight threads (more than the cores torch uses here) drive run() and
    run_many() on one engine with a 3-entry cache and a short switch
    interval: every result equals the one-thread result, and every row is
    counted once as a cache hit or miss (a lost update in the slot
    bookkeeping, or a row packed against another thread's slab write,
    would break one or the other)."""
    import sys
    import threading

    eng = _small_cache_engine(world, 3)
    specs = [(1, f"q {i}", [IMAGES[i]]) for i in range(6)]
    specs.append((12, "a pair", ["img_1", "img_4"]))
    rows = sum(len(imgs) for _, _, imgs in specs)
    want = [eng.run(r)[1].to_json() for r in _requests(eng, specs)]
    before = eng.input_cache_stats
    results, errors = {}, []

    def drive(k: int) -> None:
        try:
            reqs = _requests(eng, specs)
            out = ([eng.run(r)[1] for r in reqs] if k % 2
                   else eng.run_many(reqs, chunk_rows=4))
            results[k] = [o.to_json() for o in out]
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=drive, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert sorted(results) == list(range(8))
    for got in results.values():
        for g, w in zip(got, want):
            assert_same_result(g, w, F32)
    after = eng.input_cache_stats
    assert (after["hits"] + after["misses"]
            - before["hits"] - before["misses"]) == 8 * rows

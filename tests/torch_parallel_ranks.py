"""Rank functions of the port's parallel tests.

Each runs in a rank spawned by ``vilbert_multitask_tpu_torch.parallel.
launch.spawn_ranks`` (gloo on the CPU) and imports torch and the port
only, never JAX: the tests compute the JAX side in their own process and
pass arrays in. A rank returns numpy values (or plain Python) to the test;
rank 0's result is the one the tests read unless they say otherwise.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

F32 = dict(atol=2e-5, rtol=1e-5)


def _cfg(**kw):
    from vilbert_multitask_tpu_torch.config import ViLBertConfig

    return ViLBertConfig().tiny(**kw)


def _mesh(dp=-1, tp=1, sp=1):
    from vilbert_multitask_tpu_torch.config import MeshConfig
    from vilbert_multitask_tpu_torch.parallel import build_mesh

    return build_mesh(MeshConfig(dp=dp, tp=tp, sp=sp))


def _model(cfg, sd, mesh=None, ring_v=None):
    """A port model on the CPU with ``sd`` loaded (its tp shard on a
    mesh), in eval mode."""
    from vilbert_multitask_tpu_torch.models.vilbert import ViLBertForVLTasks
    from vilbert_multitask_tpu_torch.parallel.sharding import shard_state_dict
    from vilbert_multitask_tpu_torch.parallel.tp import layout, parallelize

    with torch.device("meta"):
        model = ViLBertForVLTasks(cfg, ring_v=ring_v)
        if mesh is not None:
            parallelize(model, mesh)
    model.to_empty(device="cpu")
    model.tie_weights()
    weights = {k: torch.as_tensor(np.asarray(v)).float()
               for k, v in sd.items()}
    if mesh is not None:
        weights = shard_state_dict(weights, mesh, layout(model))
    model.load_state_dict(weights, strict=True)
    return model.eval()


def _inputs(inp: dict) -> tuple:
    t = {k: torch.as_tensor(np.asarray(v)) for k, v in inp.items()}
    return (t["input_ids"].long(), t["features"].float(),
            t["spatials"].float(), t["segment_ids"].long(),
            t["input_mask"].long(), t["image_mask"].long(), None,
            t["task_ids"].long())


def _outputs(out) -> dict:
    fields = ("vil_prediction", "vil_prediction_gqa", "vil_logit",
              "vil_binary_prediction", "vil_tri_prediction",
              "vision_prediction", "vision_logit", "linguisic_prediction",
              "linguisic_logit")
    return {f: getattr(out, f).detach().numpy() for f in fields
            if getattr(out, f) is not None}


def _gather_grads(model, mesh) -> dict:
    from vilbert_multitask_tpu_torch.parallel import comm
    from vilbert_multitask_tpu_torch.parallel.mesh import axis
    from vilbert_multitask_tpu_torch.parallel.tp import shard_dims

    dims, tp = shard_dims(model), axis(mesh, "tp")
    out = {}
    for k, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        out[k] = (comm.all_gather(g, tp, dims[k]) if k in dims else g).numpy()
    return out


# ------------------------------------------------ tests/test_torch_parallel.py
def ops_rank(rank: int, sd: dict, inp: dict) -> dict:
    """2 ranks, tp = 2: the collectives, f64 gradchecks of the tp operators
    in their Megatron pairings (replicated input, replicated output), the
    tp model's outputs and gradients, a shard/gather round trip and
    ``place_batch``'s refusal of per-rank batches."""
    from torch.autograd import gradcheck

    from vilbert_multitask_tpu_torch.parallel import comm, distributed
    from vilbert_multitask_tpu_torch.parallel.mesh import axis
    from vilbert_multitask_tpu_torch.parallel.sharding import (
        gather_state_dict,
        place_batch,
        shard_state_dict,
    )
    from vilbert_multitask_tpu_torch.parallel.tp import (
        copy_to_tp,
        gather_from_tp,
        reduce_from_tp,
        scatter_to_tp,
    )

    mesh = _mesh(dp=1, tp=2)
    tp = axis(mesh, "tp")
    res: dict = {"runtime_info": distributed.runtime_info()}
    res["all_reduce"] = comm.all_reduce(
        torch.full((3,), float(rank + 1)), tp).tolist()
    res["all_gather"] = comm.all_gather(
        torch.full((2,), float(rank)), tp, 0).tolist()
    res["broadcast"] = comm.broadcast(
        torch.full((2,), float(rank + 5)), tp, 1).tolist()
    res["shift"] = comm.shift([torch.tensor([float(rank)])], tp)[0].tolist()

    f64 = torch.float64
    g = torch.Generator().manual_seed(0)  # the same draws on both ranks
    w1_full = torch.randn(6, 4, generator=g, dtype=f64)
    w2_full = torch.randn(3, 6, generator=g, dtype=f64)
    w1 = w1_full[3 * rank:3 * rank + 3]
    w2 = w2_full[:, 3 * rank:3 * rank + 3]
    x = torch.randn(2, 4, generator=g, dtype=f64, requires_grad=True)
    h = torch.randn(2, 6, generator=g, dtype=f64, requires_grad=True)

    def mlp(x):  # column-parallel → tanh → row-parallel
        return reduce_from_tp(torch.tanh(copy_to_tp(x, tp) @ w1.T) @ w2.T, tp)

    res["gradcheck"] = {
        "copy_to_tp+reduce_from_tp": gradcheck(mlp, (x,)),
        "copy_to_tp+gather_from_tp": gradcheck(
            lambda x: gather_from_tp(copy_to_tp(x, tp) @ w1.T, tp, -1), (x,)),
        "scatter_to_tp+reduce_from_tp": gradcheck(
            lambda h: reduce_from_tp(scatter_to_tp(h, tp, -1) @ w2.T, tp),
            (h,)),
    }
    # The reduce's backward is the identity: the gradient is not tp times
    # the single-device one.
    mlp(x).sum().backward()
    x1 = x.detach().clone().requires_grad_(True)
    (torch.tanh(x1 @ w1_full.T) @ w2_full.T).sum().backward()
    res["mlp_grad_gap"] = float((x.grad - x1.grad).abs().max())

    cfg = _cfg()
    single, sharded = _model(cfg, sd), _model(cfg, sd, mesh)
    args = _inputs(inp)
    a, b = single(*args), sharded(*args)
    res["single"], res["tp"] = _outputs(a), _outputs(b)
    heads = ("vil_prediction", "vil_binary_prediction", "vision_logit",
             "linguisic_prediction", "vision_prediction")
    for out in (a, b):  # a softmax cross-entropy of each head on class 0
        sum(torch.nn.functional.cross_entropy(
            getattr(out, f).float().reshape(-1, getattr(out, f).shape[-1]),
            torch.zeros(getattr(out, f).shape[:-1], dtype=torch.long
                        ).reshape(-1)) for f in heads).backward()
    res["grad_single"] = {k: p.grad.numpy()
                          for k, p in single.named_parameters()
                          if p.grad is not None}
    res["grad_tp"] = _gather_grads(sharded, mesh)
    res["local_shapes"] = {k: tuple(v.shape) for k, v in
                           sharded.state_dict().items()}

    weights = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
    shapes = {k: tuple(v.shape) for k, v in weights.items()}
    back = gather_state_dict(shard_state_dict(weights, mesh), mesh, shapes)
    res["round_trip"] = all(torch.equal(back[k], weights[k])
                            for k in weights)
    try:
        place_batch({"x": np.zeros((4, 2))}, mesh)
        res["per_rank_batch"] = "placed"
    except NotImplementedError as e:
        res["per_rank_batch"] = str(e)
    res["global_batch"] = place_batch(
        {"x": np.arange(8).reshape(4, 2)}, mesh, global_batch=True)[
            "x"].tolist()
    return res


def fail_on_rank_1(rank: int) -> int:
    if rank == 1:
        raise KeyError("rank 1 fails on purpose")
    return rank


def mesh_rank(rank: int) -> dict:
    """8 ranks: the axes of a 2 × 2 × 2 mesh and of the dp = -1 default."""
    from vilbert_multitask_tpu_torch.parallel import local_mesh_info
    from vilbert_multitask_tpu_torch.parallel.mesh import axis

    out = {}
    mesh = _mesh(dp=-1, tp=2, sp=2)
    out["info"] = local_mesh_info(mesh)
    out["axes"] = {n: (axis(mesh, n).size, axis(mesh, n).index,
                       axis(mesh, n).ranks) for n in ("dp", "tp", "sp")}
    out["default"] = local_mesh_info(_mesh())
    return out


# ---------------------------------------------------- tests/test_torch_ring.py
def ring_rank(rank: int, cases: dict, model_case: dict) -> dict:
    """8 ranks: ``make_ring_attention`` on each case's mesh, the
    rejections, a gradcheck of the ring, and the ring model against the
    dense one (counting the ring's calls)."""
    from torch.autograd import gradcheck

    from vilbert_multitask_tpu_torch.ops.attention import mask_to_bias
    from vilbert_multitask_tpu_torch.parallel.mesh import axis
    from vilbert_multitask_tpu_torch.parallel.ring import (
        RingContext,
        make_ring_attention,
        ring_attention_shard,
        ring_self_attention,
    )

    out: dict = {"ring": {}}
    meshes = {}

    def mesh_of(dp, sp):
        if (dp, sp) not in meshes:
            meshes[dp, sp] = _mesh(dp=dp, tp=8 // (dp * sp), sp=sp)
        return meshes[dp, sp]

    for name, c in cases.items():
        mesh = mesh_of(c["dp"], c["sp"])
        ring = make_ring_attention(
            mesh, batch_axis="dp" if c["batch_axis"] else None)
        q, k, v = (torch.from_numpy(c[n]) for n in "qkv")
        mask = torch.from_numpy(c["mask"]) if c["mask"] is not None else None
        try:
            out["ring"][name] = ring(q, k, v, mask).numpy()
        except ValueError as e:
            out["ring"][name] = f"ValueError: {e}"

    # The rotation's backward, in f64 on an sp = 2 ring.
    mesh2 = mesh_of(4, 2)
    sp2 = axis(mesh2, "sp")
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 2, 1, 2, generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    bias = mask_to_bias(torch.ones(1, 2), torch.float64)
    out["gradcheck"] = gradcheck(
        lambda q, k, v: ring_attention_shard(q, k, v, bias, axis=sp2,
                                             dtype=torch.float64), (q, k, v))
    # The model's entry: replicated q/k/v, the context replicated again;
    # every rank's gradients are the dense attention's.
    from vilbert_multitask_tpu_torch.ops.attention import (
        multi_head_attention,
    )

    ctx2 = RingContext.from_mesh(mesh2, min_seq=2)
    qkv = [torch.randn(2, 6, 2, 4, generator=g, dtype=torch.float64)
           for _ in range(3)]
    w = torch.randn(2, 6, 2, 4, generator=g, dtype=torch.float64)
    grads = []
    for fn in (lambda q, k, v: ring_self_attention(ctx2, q, k, v, None,
                                                   dtype=torch.float64),
               lambda q, k, v: multi_head_attention(
                   q, k, v, None, dtype=torch.float64)[0]):
        leaves = [t.clone().requires_grad_(True) for t in qkv]
        (fn(*leaves) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    out["self_attention_grad_gap"] = max(
        float((a - b).abs().max()) for a, b in zip(*grads))

    # The model: ring (dp 2 × sp 4, and tp 2 × sp 4) against dense.
    cfg, sd = model_case["cfg"], model_case["sd"]
    with torch.no_grad():
        out["dense"] = _outputs(_model(cfg, sd)(*_inputs(
            model_case["inputs"]["16"])))
        for name, (dp, tp, sp, min_seq, key) in model_case["runs"].items():
            mesh = _mesh(dp=dp, tp=tp, sp=sp)
            ctx = RingContext.from_mesh(mesh, min_seq=min_seq)
            model = _model(cfg, sd, mesh, ring_v=ctx)
            a = _inputs(model_case["inputs"][key])
            dpx = axis(mesh, "dp")
            n = a[0].shape[0] // dpx.size  # this rank's rows (place_batch)
            rows = (dpx.index * n, (dpx.index + 1) * n)
            a = tuple(t[rows[0]:rows[1]] if t is not None else None
                      for t in a)
            ring_self_attention.calls = 0
            got = _outputs(model(*a))
            out[name] = {"out": got, "calls": ring_self_attention.calls,
                         "rows": rows,
                         "engages": ctx.engages(a[1].shape[1])}
    return out


# ------------------------------------------ tests/test_torch_parallel_engine.py
def engine_cfg(model_cfg, **engine):
    from vilbert_multitask_tpu_torch.config import (
        EngineConfig,
        FrameworkConfig,
    )

    base = dict(max_text_len=12, compute_dtype="float32",
                use_pallas_coattention=True, use_pallas_self_attention=True)
    base.update(engine)
    return FrameworkConfig(model=model_cfg, engine=EngineConfig(**base))


def regions(n, seed=5, num_boxes=7, feat_dim=32):
    """``tests/test_engine.py:make_regions``'s regions, in the port's type."""
    from vilbert_multitask_tpu_torch.features.pipeline import RegionFeatures

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        boxes = rng.uniform(0, 200, size=(num_boxes, 4)).astype(np.float32)
        boxes[:, 2:] = boxes[:, :2] + 10 + boxes[:, 2:] * 0.3
        out.append(RegionFeatures(
            features=rng.randn(num_boxes, feat_dim).astype(np.float32),
            boxes=np.clip(boxes, 0, 640), image_width=640, image_height=480))
    return out


BACKLOG = [
    (1, "what is the man holding", 1),
    (12, "both images contain wolves", 2),
    (7, "a red car parked outside", 4),
    (15, "is the bowl right of the mug", 1),
    (12, "both show dogs", 2),
]


def result_key(r):
    """The decoded answer of a task result (labels, ranking or kind)."""
    if r.answers is not None:
        return [a["answer"] for a in r.answers]
    if r.ranking is not None:
        return [x["image"] for x in r.ranking]
    return r.kind


def attention_maps(out) -> list:
    """A forward's bridge attention maps (``collect_attention=True``) as
    numpy arrays, bridge by bridge."""
    return [[None if p is None else p.float().numpy() for p in maps]
            for maps in out.attn_data_list]


def serve_engine(cfg, mesh, sd, *, seed_regions=5, maps=False):
    """Run the engine tests' requests on rank 0 of a mesh engine (the
    other ranks follow); returns rank 0's results (with ``maps``, also the
    bridges' attention maps of the first request)."""
    from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine
    from vilbert_multitask_tpu_torch.parallel.mesh import world_axis

    eng = InferenceEngine(cfg, params=sd, mesh=mesh, device="cpu")
    if world_axis(mesh).index != 0:
        eng.follow()
        return None
    try:
        regs = regions(4, seed=seed_regions,
                       feat_dim=cfg.model.v_feature_size)
        out, res = eng.run(eng.prepare(12, "both images contain wolves",
                                       regs[:2]))
        many = eng.run_many([eng.prepare(t, q, regs[:n])
                             for t, q, n in BACKLOG])
        extra = {}
        if maps:
            got, _ = eng.run(eng.prepare(12, "both images contain wolves",
                                         regs[:2]), collect_attention=True)
            extra["maps"] = attention_maps(got)
        return {**extra, "binary": out.vil_binary_prediction.numpy(),
                "vision_logit": out.vision_logit.numpy(),
                "answers": result_key(res),
                "many": [(r.kind, result_key(r)) for r in many],
                "state_shapes": {k: tuple(np.shape(
                    v["int8"] if isinstance(v, dict) else v))
                    for k, v in eng.state_dict().items()}}
    finally:
        eng.stop_followers()


def engine_rank(rank: int, cfg, sd: dict, int8_cfg, ring_case: dict,
                ckpt_dir: str) -> dict:
    """8 ranks: the dp 4 × tp 2 engine (f32, then int8), the dp 2 × tp 2
    × sp 2 engine over a long region set, and a mesh restore."""
    from vilbert_multitask_tpu_torch.checkpoint.store import restore_params
    from vilbert_multitask_tpu_torch.parallel.ring import ring_self_attention

    out = {}
    mesh = _mesh(dp=4, tp=2)
    out["f32"] = serve_engine(cfg, mesh, sd)
    out["int8"] = serve_engine(int8_cfg, mesh, sd)
    out["restored"] = serve_engine(
        cfg, mesh, restore_params(ckpt_dir, dtype=cfg.engine.param_dtype,
                                  cfg=cfg.model, mesh=mesh))
    mesh_sp = _mesh(dp=2, tp=2, sp=2)
    ring_self_attention.calls = 0
    out["ring"] = serve_engine(ring_case["cfg"], mesh_sp, sd,
                               seed_regions=ring_case["seed"])
    out["ring_calls"] = ring_self_attention.calls
    return out


def _leaf_shapes(sd) -> dict:
    return {k: tuple(np.shape(v["int8"] if isinstance(v, dict) else v))
            for k, v in sd.items()}


def uneven_heads_rank(rank: int, cfg, sd: dict, int8_cfg, ring_case: dict,
                      ckpt_dir: str) -> dict:
    """8 ranks: the tiny config at dp 2 × tp 4, whose 2 visual and 2
    bridge heads tp does not divide (those attentions stay whole on every
    rank), in f32, int8 and restored from a checkpoint with
    ``restore_params(..., mesh=)``; then tp 4 × sp 2 over a long region
    set, the ring inside a whole visual attention."""
    from vilbert_multitask_tpu_torch.checkpoint.store import restore_params
    from vilbert_multitask_tpu_torch.parallel.ring import ring_self_attention

    out = {}
    mesh = _mesh(dp=2, tp=4)
    out["f32"] = serve_engine(cfg, mesh, sd, maps=True)
    out["int8"] = serve_engine(int8_cfg, mesh, sd)
    restored = restore_params(ckpt_dir, dtype=cfg.engine.param_dtype,
                              cfg=cfg.model, mesh=mesh)
    out["restored_shapes"] = _leaf_shapes(restored)
    out["restored"] = serve_engine(cfg, mesh, restored)
    ring_self_attention.calls = 0
    out["ring"] = serve_engine(ring_case["cfg"], _mesh(dp=1, tp=4, sp=2), sd,
                               seed_regions=ring_case["seed"])
    out["ring_calls"] = ring_self_attention.calls
    return out


REFUSED_QUESTION = "is it raining"


def swap_rank(rank: int, cfg, feature_root: str, old_ckpt: str,
              new_ckpt: str) -> dict:
    """2 ranks at tp 2: ``ServeApp`` (rank 0) booted from ``old_ckpt``
    answers a job. Three swaps are refused and the job answers as before
    each time: to ``new_ckpt`` and to its tree in memory, each failed by an
    ``engine.load`` fault planned on rank 1 alone (two injections), and to
    a tree with one leaf of a wrong shape. Then a swap to ``new_ckpt``
    succeeds while another job is claimed, an in-memory swap back to the
    old tree follows, and one more to the new tree succeeds while a job is
    claimed; a job answers after each. Last, an int8 engine at tp 2 (rank
    1 following) loads the new f32 tree from rank 0's memory, and a
    one-device int8 engine loads the same tree: both answer the engine
    tests' first request."""
    import threading

    from vilbert_multitask_tpu_torch.checkpoint.store import restore_params
    from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine
    from vilbert_multitask_tpu_torch.resilience.faults import (
        FaultPlan,
        FaultRule,
        install_plan,
    )
    from vilbert_multitask_tpu_torch.serve.app import ServeApp, follow_rank
    from vilbert_multitask_tpu_torch.serve.queue import make_job_message

    int8_cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, param_dtype="int8"))
    if rank != 0:
        install_plan(FaultPlan(rules=[FaultRule("engine.load",
                                                max_injections=2)]))
        follow_rank(cfg, checkpoint_path=old_ckpt, device="cpu")
        InferenceEngine(int8_cfg, mesh=_mesh(dp=1, tp=2),
                        device="cpu").follow()
        return {}
    trees = {name: restore_params(path, cfg=cfg.model)
             for name, path in (("old", old_ckpt), ("new", new_ckpt))}
    app = ServeApp(cfg, feature_root=feature_root, checkpoint_path=old_ckpt,
                   device="cpu")
    jobs = iter(range(100))

    def answer(question="what is the man holding") -> dict:
        app.queue.publish(make_job_message(
            ["img_a.jpg"], question, 1, f"sock{next(jobs)}"))
        assert app.worker.step() == "acked"
        return app.store.recent()[0]["answer_text"]

    def refused(**swap) -> str:
        try:
            app.rolling_swap(**swap)
        except RuntimeError as e:
            return str(e)
        return ""

    def swap_during_a_job(**swap) -> tuple:
        box: dict = {}
        t = threading.Thread(target=lambda: box.update(
            report=app.rolling_swap(**swap)))
        t.start()
        during = answer("what is on the table")
        t.join()
        return box["report"], during

    bad = dict(trees["new"])
    bad_key = next(k for k in sorted(bad) if np.ndim(bad[k]) == 2)
    bad[bad_key] = bad[bad_key][:-1]
    try:
        app.engine.mark_ready()
        info = {"before": answer(), "bad_key": bad_key,
                "tree_bytes": sum(np.asarray(v).nbytes
                                  for v in trees["new"].values())}
        # another question: the same one would be the result cache's hit
        info["refused"] = refused(checkpoint_path=new_ckpt)
        info["after_refused"] = answer(REFUSED_QUESTION)
        info["refused_tree"] = refused(params=trees["new"])
        info["after_refused_tree"] = answer(REFUSED_QUESTION)
        info["bad_shape"] = refused(params=bad)
        info["after_bad_shape"] = answer(REFUSED_QUESTION)
        info["gen_after_refused"] = app.model_gen
        info["report"], info["during"] = swap_during_a_job(
            checkpoint_path=new_ckpt)
        info["after"] = answer()
        info["last_swap"] = app.boot_info.get("last_swap")
        info["tree_old_report"] = app.rolling_swap(params=trees["old"])
        info["tree_old"] = answer()
        info["tree_report"], info["during_tree"] = swap_during_a_job(
            params=trees["new"])
        info["after_tree"] = answer()
        info["last_tree_swap"] = app.boot_info.get("last_swap")
        info["answered"] = len(app.store.recent(limit=100))
    finally:
        app.stop()
    eng = InferenceEngine(int8_cfg, mesh=_mesh(dp=1, tp=2), device="cpu")
    try:
        info["int8_bytes"] = eng.broadcast_params(trees["new"])
        info["int8_mesh"] = _first_request(eng)
    finally:
        eng.stop_followers()
    info["int8_one_device"] = _first_request(InferenceEngine(
        int8_cfg, params=trees["new"], device="cpu"))
    return info


def _first_request(eng) -> dict:
    """``serve_engine``'s first request on ``eng``: its binary logits and
    decoded answer."""
    regs = regions(2, feat_dim=eng.cfg.model.v_feature_size)
    out, res = eng.run(eng.prepare(12, "both images contain wolves", regs))
    return {"binary": out.vil_binary_prediction.numpy(),
            "answers": result_key(res)}


def idle_rank(rank: int, cfg, sd: dict, idle_s: float) -> dict:
    """2 ranks at dp 2: rank 0 serves an NLVR2 pair, stays idle for
    ``idle_s`` (longer than the world's process-group timeout), then serves
    it again; rank 1 follows throughout."""
    import time

    from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine

    eng = InferenceEngine(cfg, params=sd, mesh=_mesh(), device="cpu")
    if rank != 0:
        eng.follow()
        return {}
    try:
        regs = regions(2, feat_dim=cfg.model.v_feature_size)
        out = []
        for wait in (0.0, idle_s):
            time.sleep(wait)
            got, _ = eng.run(eng.prepare(12, "both images contain wolves",
                                         regs))
            out.append(got.vil_binary_prediction.numpy())
        return {"before": out[0], "after": out[1]}
    finally:
        eng.stop_followers()


def serve_rank(rank: int, cfg, feature_root: str) -> dict:
    """2 ranks: ``ServeApp`` built by rank 0 of a launch serves a job
    through the dp mesh; rank 1 follows (``serve.app.follow_rank``)."""
    from vilbert_multitask_tpu_torch.serve.app import ServeApp, follow_rank
    from vilbert_multitask_tpu_torch.serve.queue import make_job_message

    if rank != 0:
        follow_rank(cfg, device="cpu")
        return {}
    app = ServeApp(cfg, feature_root=feature_root, device="cpu")
    try:
        mesh = app.engine.mesh
        info = {"mesh": None if mesh is None else
                dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}
        app.engine.mark_ready()  # what start() does for a no-warmup boot
        app.queue.publish(make_job_message(
            ["img_a.jpg", "img_b.jpg"], "a caption", 7, "sockM"))
        info["step"] = app.worker.step()
        row = app.store.recent()[0]
        info["answer"] = row["answer_text"]
        return info
    finally:
        app.stop()


# ------------------------------------------- tests/test_torch_parallel_train.py
def train_cfg(model_cfg):
    from vilbert_multitask_tpu_torch.config import (
        EngineConfig,
        FrameworkConfig,
    )

    return FrameworkConfig(
        model=model_cfg,
        engine=EngineConfig(max_text_len=12, max_regions=9,
                            compute_dtype="float32",
                            use_pallas_coattention=False,
                            use_pallas_self_attention=False))


def _loop(steps, **kw):
    from vilbert_multitask_tpu_torch.train.loop import LoopConfig

    kw.setdefault("batch_size", 8)
    kw.setdefault("log_every", 1)
    kw.setdefault("ckpt_every", 10_000)
    kw.setdefault("warmup_steps", 1)
    kw.setdefault("learning_rate", 1e-4)
    return LoopConfig(total_steps=steps, **kw)


def _trainer(cfg, loop, mesh, out_dir=None, heads=("vqa", "tri"), **kw):
    from vilbert_multitask_tpu_torch.train.loop import (
        MultiTaskSampler,
        SyntheticTaskData,
        Trainer,
    )

    logs = []
    t = Trainer(cfg, MultiTaskSampler({h: SyntheticTaskData(h, cfg)
                                       for h in heads}),
                loop, out_dir=out_dir, mesh=mesh, device="cpu",
                log_fn=logs.append, **kw)
    return t, logs


def _global_params(state) -> dict:
    from vilbert_multitask_tpu_torch.checkpoint.store import _gathered

    tree = _gathered(state.params, state) if state.mesh else state.params
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def step_rank(rank: int, cfg, sd: dict, batch: dict) -> dict:
    """4 ranks: three steps of the mesh train step (dp 2 × tp 2, and tp 4),
    dropout off, and of the single-device step, from the same weights and
    batch; and the clip's count over a tp 4 axis."""
    from vilbert_multitask_tpu_torch.parallel.mesh import axis
    from vilbert_multitask_tpu_torch.train import losses, step

    out = {}
    for name, (dp, tp) in {"dp2_tp2": (2, 2), "dp1_tp4": (1, 4),
                           "single": (1, 1)}.items():
        if name == "dp1_tp4" and cfg.num_attention_heads % 4:
            continue
        mesh = _mesh(dp=dp, tp=tp) if dp * tp > 1 else None
        model = _model(cfg, sd, mesh)
        tx = step.default_optimizer(learning_rate=1e-4, warmup_steps=1,
                                    total_steps=10)
        state = step.create_train_state(model, tx, mesh=mesh)
        fn = step.make_train_step(model, tx, losses.LossConfig(
            heads=("vqa", "tri", "binary", "grounding", "mlm")))
        metrics = []
        for _ in range(3):
            state, m = fn(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = {"metrics": metrics, "params": _global_params(state)}
        if mesh is not None:
            out[name]["sharded"] = sorted(state.shard_dims)
            out[name]["tp_shape"] = tuple(state.params[
                "bert.encoder.layer.0.intermediate.dense.weight"].shape)
            out[name]["mu_shape"] = tuple(state.mu[
                "bert.encoder.layer.0.intermediate.dense.weight"].shape)
            out[name]["dp"] = axis(mesh, "dp").size
    # The clip's count: a replicated leaf once, a sharded one summed.
    mesh = _mesh(dp=1, tp=4)
    tp = axis(mesh, "tp")
    rep_leaf = torch.full((3,), 2.0)  # the same on every tp rank
    shard = torch.full((2,), float(rank + 1))  # this rank's shard
    _, norm = step.clip_by_global_norm([rep_leaf, shard], 1e9,
                                       sharded=[False, True], tp_axis=tp)
    out["clip_norm"] = float(norm)
    return out


def loop_rank(rank: int, cfg, ckpt_dir: str, golden: str,
              single_dir: str) -> dict:
    """4 ranks, dp 2 × tp 2: the loop, a snapshot and a bit-exact resume on
    a fresh mesh, the snapshots restored into fresh mesh states (the
    mesh's and a single-device one's), and ``EvalHook`` on the sharded
    parameters."""
    from vilbert_multitask_tpu_torch.checkpoint.store import (
        restore_train_state,
    )
    from vilbert_multitask_tpu_torch.evals.harness import load_jsonl
    from vilbert_multitask_tpu_torch.features.store import FeatureStore
    from vilbert_multitask_tpu_torch.train.loop import EvalHook

    out = {}
    ref, logs = _trainer(cfg, _loop(4), _mesh(dp=2, tp=2))
    ref.train()
    out["logs"] = logs
    out["ref"] = _global_params(ref.state)
    out["sharded_shape"] = tuple(ref.state.params[
        "bert.encoder.layer.0.intermediate.dense.weight"].shape)
    a, _ = _trainer(cfg, _loop(2, ckpt_every=2), _mesh(dp=2, tp=2), ckpt_dir)
    a.train()
    b, _ = _trainer(cfg, _loop(4, ckpt_every=2), _mesh(dp=2, tp=2), ckpt_dir)
    out["resumed_step"] = b.state.step
    b.train()
    out["resumed"] = _global_params(b.state)
    out["snapshots"] = sorted(os.listdir(ckpt_dir))
    # The mesh snapshot of step 2 restored into a fresh mesh state.
    c, _ = _trainer(cfg, _loop(4), _mesh(dp=2, tp=2))
    restore_train_state(os.path.join(ckpt_dir, "step_00000002"), c.state)
    out["restored_step2"] = _global_params(c.state)
    d, _ = _trainer(cfg, _loop(4), _mesh(dp=2, tp=2))
    restore_train_state(os.path.join(single_dir, "step_00000002"), d.state)
    out["from_single"] = _global_params(d.state)

    hook = EvalHook(cfg, FeatureStore(os.path.join(golden, "features")),
                    {"nlvr2": load_jsonl(os.path.join(golden, "nlvr2.jsonl"))},
                    mesh=a.mesh, device="cpu")
    out["eval"] = hook(1, a.state)
    return out



"""Rank functions of the data-parallel tests, run by :func:`torch_dp.spawn`
in processes that import torch and the port only. Each takes (rank,
world, **kwargs) and returns numpy results."""

import numpy as np
import torch


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def _block(a, world, rank):
    return torch.from_numpy(np.ascontiguousarray(
        np.array_split(a, world)[rank]))


# ---------------------------------------------------------------------------
# the facade, the coalesced collectives, the logger and the mesh
# ---------------------------------------------------------------------------

def collectives(rank, world, arrays):
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.comm import coalesced
    from deepspeed_tpu_torch.comm.comms_logger import comms_logger
    from deepspeed_tpu_torch.parallel import mesh as M
    m = M.build_mesh()
    out = {"data": m.shape["data"], "dp": M.get_data_parallel_world_size(),
           "index": comm.axis_index("data"), "rank": comm.get_rank(),
           "world": comm.get_world_size()}
    f = _block(arrays["f"], world, rank)
    i = _block(arrays["i"], world, rank)
    g = _block(arrays["g"], world, rank)
    h = _block(arrays["h"], world, rank)
    for op in ("sum", "mean", "max", "min"):
        out[op] = comm.all_reduce(f, "data", op)
    out["isum"] = comm.all_reduce(i, "data")
    out["gather0"] = comm.all_gather(f, "data", axis=0)
    out["gather1"] = comm.all_gather(f, "data", axis=1)
    out["gather_untiled"] = comm.all_gather(f, "data", axis=0, tiled=False)
    out["gather_async"] = comm.all_gather(f, "data", async_op=True).wait()
    out["rs0"] = comm.reduce_scatter(g, "data", axis=0)
    out["rs1"] = comm.reduce_scatter(h, "data", axis=1)
    out["a2a"] = comm.all_to_all(g, "data", split_axis=0, concat_axis=1)
    out["ring"] = comm.ppermute(f, "data", [(j, (j + 1) % world)
                                            for j in range(world)])
    out["partial"] = comm.ppermute(f, "data", [(0, 1)])
    out["next"] = comm.send_recv_next(f, "data", world)
    out["prev"] = comm.send_recv_prev(f, "data", world)
    cs = [_block(arrays["c0"], world, rank), _block(arrays["c1"], world,
                                                    rank)]
    out["rs_coalesced"] = coalesced.reduce_scatter_coalesced(cs, "data")
    out["ar_coalesced"] = coalesced.all_reduce_coalesced(cs, "data")
    out["ag_coalesced"] = coalesced.all_gather_coalesced(cs, "data")
    # the round trip: a rank's chunk of the reduced flat bucket, gathered
    # back, is the all-reduced bucket
    back = comm.all_gather(out["rs_coalesced"], "data")
    flat = torch.cat([t.reshape(-1) for t in out["ar_coalesced"]])
    out["round_trip_err"] = float((back[:flat.numel()] - flat).abs().max())
    try:
        coalesced.all_reduce_coalesced([i], "data")
        out["int_refused"] = False
    except TypeError:
        out["int_refused"] = True
    comms_logger.enabled, comms_logger.prof_all = True, True
    comms_logger.reset()
    comm.all_reduce(f, "data")
    comm.all_reduce(f, "data")
    comm.all_gather(g, "data")
    coalesced.all_reduce_coalesced(cs, "data")
    out["records"] = {op: {s: list(v) for s, v in sizes.items()}
                      for op, sizes in comms_logger.comms_dict.items()}
    out["bytes_by_op"] = comms_logger.bytes_by_op()
    comms_logger.enabled = False
    raises = {}
    try:
        M.build_mesh(data=world + 1)
    except ValueError as e:
        raises["product"] = str(e)
    out["raises"] = raises
    # the data_inner axis (MiCS): between 'data' and 'expert' in the rank
    # order, one group a data row (the sub-group) and one a column
    im = M.build_mesh(data=world // 2, data_inner=2)
    me = torch.tensor([float(rank)])
    out["inner_mesh"] = {
        "coords": (im.coord("data"), im.coord("data_inner")),
        "inner_sum": float(comm.all_reduce(me, "data_inner")),
        "data_sum": float(comm.all_reduce(me, "data")),
        "inner_index": comm.axis_index("data_inner"),
        "dp": M.get_data_parallel_world_size(im)}
    # the pipe axis: the slowest in the rank order, one group a data row
    # (the stages) and one a stage (its data ranks)
    pm = M.build_mesh(data=world // 2, pipe=2)
    me = torch.tensor([float(rank)])
    out["pipe_mesh"] = {
        "coords": (pm.coord("pipe"), pm.coord("data")),
        "pipe_sum": float(comm.all_reduce(me, "pipe")),
        "data_sum": float(comm.all_reduce(me, "data")),
        "pipe_index": comm.axis_index("pipe"),
        "pp": M.get_pipe_parallel_world_size(pm),
        "dp": M.get_data_parallel_world_size(pm),
        "next": comm.ppermute(me, "pipe", [(0, 1)]).tolist()}
    # the seq axis: between 'expert' and 'model' in the rank order, one
    # group a data row
    sm = M.build_mesh(data=world // 2, seq=2)
    me = torch.tensor([float(rank)])
    out["seq_mesh"] = {
        "coords": (sm.coord("data"), sm.coord("seq")),
        "seq_sum": float(comm.all_reduce(me, "seq")),
        "data_sum": float(comm.all_reduce(me, "data")),
        "seq_index": comm.axis_index("seq"),
        "sp": M.get_sequence_parallel_world_size(sm),
        "dp": M.get_data_parallel_world_size(sm)}
    # the expert axis: between 'data' and 'model' in the rank order, one
    # group an expert row, one a column (expert-data-parallel), and the
    # ZeRO family's ('data', 'expert')
    em = M.build_mesh(data=world // 2, expert=2)
    me = torch.tensor([float(rank)])
    out["expert_mesh"] = {
        "coords": (em.coord("data"), em.coord("expert")),
        "expert_sum": float(comm.all_reduce(me, "expert")),
        "data_sum": float(comm.all_reduce(me, "data")),
        "family_sum": float(comm.all_reduce(me, ("data", "expert"))),
        "expert_index": comm.axis_index("expert"),
        "family_index": comm.axis_index(("data", "expert")),
        "ep": M.get_expert_parallel_world_size(em),
        "dp": M.get_data_parallel_world_size(em),
        "exchange": comm.expert_exchange(
            torch.arange(4, dtype=torch.float32) + 10 * rank,
            "expert").tolist()}
    # the training layer's pair: the row's sum scattered by blocks, then
    # gathered back; each backward is the other's forward
    x = (torch.arange(4, dtype=torch.float32) + 10 * rank).requires_grad_()
    sc = comm.scatter_to_experts(x, "expert")
    ga = comm.gather_from_experts(sc, "expert")
    (ga * (rank + 1)).sum().backward()
    out["expert_mesh"].update(scatter=sc.tolist(), gather=ga.tolist(),
                              pair_grad=x.grad.tolist())
    # the model axis: 'model' fastest, one group a data row and a column
    mm = M.build_mesh(data=world // 2, model=2)
    me = torch.tensor([float(rank)])
    out["model_mesh"] = {
        "coords": (mm.coord("data"), mm.coord("model")),
        "model_sum": float(comm.all_reduce(me, "model")),
        "data_sum": float(comm.all_reduce(me, "data")),
        "world_sum": float(comm.all_reduce(me, ("data", "model"))),
        "model_index": comm.axis_index("model"),
        "data_index": comm.axis_index("data")}
    return _np(out)


# ---------------------------------------------------------------------------
# the engine at dp > 1
# ---------------------------------------------------------------------------

def _model(spec):
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models.mixtral import mixtral_config
    preset, kw = spec
    fn = mixtral_config if preset == "mixtral_config" else getattr(dt,
                                                                  preset)
    return fn("tiny", **kw)


def _full(eng, tensors, dims):
    """Whole tensors from this rank's shards along ``dims``."""
    from deepspeed_tpu_torch import comm
    return [t if d is None else comm.all_gather(t, "data", axis=d)
            for t, d in zip(tensors, dims)]


def engine_runs(rank, world, runs):
    """Each run: {"name", "model": (preset, kw), "config", "params" (numpy
    tree or None), "steps": [[global micro-batch, ...] a step], "mode":
    "train" | "grads" | "poison" | "raises"}."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    mesh = build_mesh(data=world)
    out = {}
    for run in runs:
        cfg = _model(run["model"])
        mode = run.get("mode", "train")
        if mode == "raises":
            try:
                dt.initialize(cfg, dict(run["config"]), device="cpu",
                              mesh=mesh)
                out[run["name"]] = None
            except NotImplementedError as e:
                out[run["name"]] = str(e)
            continue
        eng = dt.initialize(cfg, dict(run["config"]), params=run.get(
            "params"), device="cpu", mesh=mesh)[0]
        res = {}
        if mode == "grads":
            batch = run["steps"][0][0]
            res["loss"] = float(eng.forward(batch))
            eng.backward(None)
            dims = [p if p is not None else g
                    for p, g in zip(eng._pdim, eng._gdim)]
            res["grads"] = [x.numpy() / world for x in _full(
                eng, eng._acc_grads, dims)]
            res["names"] = list(_paths(eng.params))
            out[run["name"]] = res
            continue
        if mode == "poison":
            _poison_last_rank(eng, rank, world)
        before = _np(eng.gathered_params())
        losses, scales, skipped = [], [], []
        for step in run["steps"]:
            losses.append(float(eng.train_batch(iter(step))))
            scales.append(float(eng.loss_scale()))
            skipped.append(eng.skipped_steps)
            if mode == "poison" and len(losses) == 1:
                res["after_skip"] = _np(eng.gathered_params())
        res.update(losses=losses, scales=scales, skipped=skipped,
                   params=_np(eng.gathered_params()),
                   grad_norm=eng.get_global_grad_norm())
        if mode == "poison":
            res["before"] = before
        if run.get("eval") is not None:
            res["eval"], res["eval_chunks"] = _eval_chunks(eng, run["eval"])
        if run.get("layout"):
            res["layout"] = {"pdim": eng._pdim, "sdim": eng._sdim,
                             "gdim": eng._gdim,
                             "local": [tuple(x.shape) for x in
                                       tree_leaves(eng.params)]}
        out[run["name"]] = res
    return out


def _eval_chunks(eng, micros):
    """eval_batch's loss over ``micros``, and for each chunk the stage-3
    loop ran: whether it computed with autograd on or gave an output that
    carries a graph."""
    import torch
    plan = eng._overlap_plan
    loop, seen = plan.layer_loop, []

    def spy(run_layers, x, layers):
        def run(xk, chunk, lo):
            y, a = run_layers(xk, chunk, lo)
            seen.append(torch.is_grad_enabled() or y.requires_grad)
            return y, a
        return loop(run, x, layers)
    plan.layer_loop = spy
    try:
        loss = float(eng.eval_batch(iter(micros)))
    finally:
        del plan.layer_loop
    return loss, seen


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix


def _poison_last_rank(eng, rank, world):
    """The last rank's reduced gradient of its first sharded leaf gets an
    inf at the first step: only that rank sees the overflow locally."""
    orig = eng._reduce_grads

    def poisoned(grads):
        out = orig(grads)
        if rank == world - 1 and eng.global_steps == 0:
            k = next(i for i in range(len(out)) if eng._sharded(i))
            out[k][(0,) * out[k].dim()] = float("inf")
        return out
    eng._reduce_grads = poisoned


# ---------------------------------------------------------------------------
# checkpoints and elastic resume
# ---------------------------------------------------------------------------

def checkpoint_dp2(rank, world, model, config, params, steps, jax_dir,
                   save_dir):
    """Load the JAX save at dp 2; then train from ``params``, save after
    two steps (per-rank shards) and go on for the rest (the uninterrupted
    run)."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    mesh = build_mesh(data=world)
    cfg = _model(model)
    out = {}
    eng = dt.initialize(cfg, dict(config), params=params, device="cpu",
                        mesh=mesh)[0]
    tag, _ = eng.load_checkpoint(jax_dir)
    out["jax_tag"] = tag
    out["jax_loaded"] = _np(eng.gathered_params())
    out["jax_loaded_opt"] = _np(_full_state(eng))
    eng = dt.initialize(cfg, dict(config), params=params, device="cpu",
                        mesh=mesh)[0]
    losses = []
    for s, step in enumerate(steps):
        losses.append(float(eng.train_batch(iter(step))))
        if s == 1:
            eng.save_checkpoint(save_dir)
            out["saved_params"] = _np(eng.gathered_params())
            out["saved_opt"] = _np(_full_state(eng))
            out["local_shapes"] = [tuple(x.shape) for x in eng._leaves]
    out["losses"] = losses
    return out


def _full_state(eng):
    """The optimizer's moment trees, each leaf whole."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves
    from deepspeed_tpu_torch.runtime.engine import _cut_dim, _unflatten_like
    out = {}
    for k, v in eng.opt_state.items():
        if not isinstance(v, dict):
            out[k] = v
            continue
        leaves = []
        for x, full in zip(tree_leaves(v), eng._full_shapes):
            if x.dim() and tuple(x.shape) != full:
                x = comm.all_gather(x, "data",
                                    axis=_cut_dim(tuple(x.shape), full))
            leaves.append(x)
        out[k] = _unflatten_like(v, leaves)
    return out


def elastic_dp4(rank, world, model, config, save_dir, steps):
    """Re-form at this world size from the latest tag and train on."""
    from deepspeed_tpu_torch.elasticity import elastic_resume
    eng, agent, tag = elastic_resume(_model(model), dict(config), save_dir,
                                     world_size=world, device="cpu")
    agent.uninstall()
    return {"tag": tag, "steps": eng.global_steps,
            "gas": eng.gradient_accumulation_steps(),
            "micro": eng.train_micro_batch_size_per_gpu,
            "losses": [float(eng.train_batch(iter(step))) for step in steps]}


# ---------------------------------------------------------------------------
# tensor parallelism: the engine on data × model
# ---------------------------------------------------------------------------

def tp_engine_runs(rank, world, data, model, runs):
    """``engine_runs``' "train" and "raises" modes on
    ``build_mesh(data=data, model=model)``, or on a run's own ``mesh``;
    each result adds this rank's mesh coordinates and the local shapes of
    its leaves."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    mesh = build_mesh(data=data, model=model)
    out = {}
    for run in runs:
        cfg = _model(run["model"])
        if run.get("mode") == "raises":
            try:
                dt.initialize(cfg, dict(run["config"]), device="cpu",
                              mesh=mesh)
                out[run["name"]] = None
            except (NotImplementedError, ValueError) as e:
                out[run["name"]] = str(e)
            continue
        # a run may name its own mesh (the runs after it keep it)
        mesh = build_mesh(**run["mesh"]) if "mesh" in run else mesh
        eng = dt.initialize(cfg, dict(run["config"]), params=run.get(
            "params"), device="cpu", mesh=mesh)[0]
        losses = [float(eng.train_batch(iter(step)))
                  for step in run["steps"]]
        out[run["name"]] = {
            "losses": losses, "params": _np(eng.gathered_params()),
            "grad_norm": eng.get_global_grad_norm(),
            "coords": (mesh.coord("data"), mesh.coord("model")),
            "local": [tuple(x.shape) for x in tree_leaves(eng.params)],
            "mdim": list(eng._mdim)}
    return out


def tp_serving(rank, world, runs):
    """The v1 and encoder engines on ``build_mesh(model=world)``. Each
    run: {"name", "cfg" (a DecoderConfig's fields), "params" (numpy tree:
    float, or pre-quantized with int8 leaves), "config", "kind": "v1" |
    "encoder", "prompt"/"seqs", "new"}; a ValueError becomes its
    message."""
    from deepspeed_tpu_torch.inference import (EncoderInference,
                                               init_inference)
    from deepspeed_tpu_torch.models.convert import params_from_jax
    from deepspeed_tpu_torch.models.transformer import DecoderConfig
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    build_mesh(model=world)
    out = {}
    for run in runs:
        cfg = DecoderConfig(**run["cfg"])
        params = run.get("params")
        if params is not None:
            params = params_from_jax(params, device="cpu")
        try:
            if run["kind"] == "encoder":
                eng = EncoderInference(cfg, run["config"], params=params,
                                       device="cpu")
                out[run["name"]] = {"logits": eng(run["seqs"])}
                continue
            eng = init_inference(cfg, run["config"], params=params,
                                 device="cpu")
        except ValueError as e:
            out[run["name"]] = str(e)
            continue
        res = {"tokens": eng.generate(run["prompt"],
                                      max_new_tokens=run["new"]),
               "logits": eng.forward(run["prompt"]).numpy(),
               "wq": tuple(eng.params["layers"]["attn"]["wq"].shape),
               "cache_heads": eng._kv_heads}
        out[run["name"]] = res
    return out



# ---------------------------------------------------------------------------
# ZeRO++: the quantized collectives and the engine
# ---------------------------------------------------------------------------

def zeropp_runs(rank, world, arrays, runs):
    """``arrays``: {name: [world, n] float32}; each rank gives row
    ``rank`` to the quantized collectives. ``runs``: as
    ``engine_runs``' "train" (losses) and "raises" (a ValueError's
    message) modes on build_mesh(data=world)."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.comm import comms_logger
    from deepspeed_tpu_torch.comm.quantized import (all_to_all_quant_reduce,
                                                    quantized_all_gather,
                                                    quantized_reduce_scatter)
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    mesh = build_mesh(data=world)
    comms_logger.enabled = True
    comms_logger.comms_dict.clear()
    out = {"coll": {}}
    for name, a in arrays.items():
        x = torch.from_numpy(np.ascontiguousarray(a[rank]))
        out["coll"][name] = {
            "gather": quantized_all_gather(x, "data"),
            "rs": quantized_reduce_scatter(x, "data"),
            "rs_sum": quantized_reduce_scatter(x, "data", mean=False),
            "rs4": quantized_reduce_scatter(x, "data", bits=4),
            "a2a": all_to_all_quant_reduce(x, "data")}
    out["bytes"] = comms_logger.bytes_by_op()
    comms_logger.enabled = False
    for run in runs:
        cfg = _model(run["model"])
        try:
            eng = dt.initialize(cfg, dict(run["config"]),
                                params=run.get("params"), device="cpu",
                                mesh=mesh)[0]
        except ValueError as e:
            out[run["name"]] = str(e)
            continue
        losses = [float(eng.train_batch(iter(step)))
                  for step in run["steps"]]
        out[run["name"]] = {"losses": losses,
                            "params": _np(eng.gathered_params()),
                            "chunk": tuple(eng.params["flat"].shape)
                            if "flat" in eng.params else None}
    return _np(out)


def checkpoint_tp(rank, world, model, params, steps, jax_dir, save_dir,
                  configs):
    """On build_mesh(data=2, model=2): load the JAX save at stage 1 and
    train on; train from ``params`` at stage 3, save after one step; then
    on build_mesh(data=4) load that save at stage 1."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    cfg = _model(model)
    mesh = build_mesh(data=2, model=2)
    out = {}
    eng = dt.initialize(cfg, dict(configs["load"]), params=params,
                        device="cpu", mesh=mesh)[0]
    out["jax_tag"], _ = eng.load_checkpoint(jax_dir)
    out["jax_loaded"] = _np(eng.gathered_params())
    out["losses"] = [float(eng.train_batch(iter(s))) for s in steps[1:]]
    eng = dt.initialize(cfg, dict(configs["save"]), params=params,
                        device="cpu", mesh=mesh)[0]
    eng.train_batch(iter(steps[0]))
    eng.save_checkpoint(save_dir)
    out["saved"] = _np(eng.gathered_params())
    out["mdim"] = list(eng._mdim)
    eng = dt.initialize(cfg, dict(configs["dp4"]), params=params,
                        device="cpu", mesh=build_mesh(data=4))[0]
    out["dp4_tag"], _ = eng.load_checkpoint(save_dir)
    out["dp4_loaded"] = _np(eng.gathered_params())
    return out


def tp_model_init_ranks(rank, world, model, config, steps):
    """tests/test_config.py:131 at model=world: dtypes, local shapes,
    the conflicting-mesh refusal, and the blocks of the full draw; then
    ``initialize`` on fp32 ``tp_model_init`` shards, trained on
    ``steps``."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models.transformer import init_params
    cfg = _model(model)
    params, mesh = dt.tp_model_init(cfg, tp_size=world, dtype="bfloat16",
                                    device="cpu")
    p16, _ = dt.tp_model_init(cfg, tp_size=world, dtype="fp16",
                              device="cpu")
    try:
        dt.tp_model_init(cfg, tp_size=world * 2, dtype="bfloat16",
                         device="cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    full = init_params(cfg, torch.Generator(device="cpu").manual_seed(0),
                       torch.bfloat16, "cpu")
    p32, _ = dt.tp_model_init(cfg, tp_size=world, dtype="float32",
                              device="cpu")
    eng = dt.initialize(cfg, dict(config), params=p32, device="cpu",
                        mesh=mesh)[0]
    losses = [float(eng.train_batch(iter(step))) for step in steps]
    return {"model_axis": mesh.shape["model"], "still": dt.parallel.mesh
            .get_mesh().shape["model"], "refused": refused,
            "wq_dtype": str(params["layers"]["attn"]["wq"].dtype),
            "p16_dtype": str(p16["layers"]["attn"]["wq"].dtype),
            "params": _np(_f32(params)), "full": _np(_f32(full)),
            "trained": {"losses": losses,
                        "params": _np(eng.gathered_params())}}


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def zeropp_checkpoint(rank, world, model, params, config, steps, jax_dir,
                      save_dir):
    """ZeRO++ at dp ``world``: train, save, and reload in a fresh engine;
    then load the JAX ZeRO++ engine's save. Each returns the whole flat
    buffer (one exact all-gather)."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    mesh = build_mesh(data=world)
    cfg = _model(model)

    def flat(eng):
        return comm.all_gather(eng.params["flat"].detach(), "data").numpy()
    eng = dt.initialize(cfg, dict(config), params=params, device="cpu",
                        mesh=mesh)[0]
    for s in steps:
        eng.train_batch(iter(s))
    eng.save_checkpoint(save_dir)
    out = {"saved": flat(eng),
           "saved_opt": {k: v["flat"].numpy().copy() for k, v in
                         eng.opt_state.items() if isinstance(v, dict)}}
    fresh = dt.initialize(cfg, dict(config), device="cpu", mesh=mesh)[0]
    out["tag"], _ = fresh.load_checkpoint(save_dir)
    out["reloaded"] = flat(fresh)
    out["reloaded_opt"] = {k: v["flat"].numpy().copy() for k, v in
                           fresh.opt_state.items() if isinstance(v, dict)}
    out["next_loss"] = [float(e.train_batch(iter(steps[0])))
                        for e in (eng, fresh)]
    jax_eng = dt.initialize(cfg, dict(config), device="cpu", mesh=mesh)[0]
    out["jax_tag"], _ = jax_eng.load_checkpoint(jax_dir)
    out["jax_loaded"] = flat(jax_eng)
    return out


# ---------------------------------------------------------------------------
# expert parallelism: the engine on data × expert (× model) and serving
# ---------------------------------------------------------------------------

def _count_drops(tm, seen):
    """Wrap ``topk_gating_rows`` (the split batch's gating) to add each
    call's (slots kept, choices) to ``seen``."""
    inner = tm.topk_gating_rows

    def spy(logits_all, logits, lo, k, capacity, **kw):
        d, c, a = inner(logits_all, logits, lo, k, capacity, **kw)
        seen.append((int(d.sum()), logits.shape[0] * k))
        return d, c, a
    tm.topk_gating_rows = spy
    return inner


def ep_runs(rank, world, meshes):
    """``meshes``: [{"shape": build_mesh kwargs, "runs": [...]}]. Each run:
    {"name", "model": (preset, kw), "config", "params" (numpy tree or
    None), "steps", "mode": "train" | "raises" | "save" | "load" |
    "elastic", "perm" (random token selection's permutation), "dir"}.
    "train" and "save" return the losses, aux losses, the gathered params,
    the norm, the rank's mesh coordinates, its local shapes and the drops
    seen; "save" writes a checkpoint after the steps; "load" loads
    ``dir`` (the JAX save) and returns the gathered params and moments;
    "elastic" re-forms from ``dir`` at data = world and trains on."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves
    from deepspeed_tpu_torch.parallel import moe as tm
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    out = {}
    for block in meshes:
        mesh = build_mesh(**block["shape"])
        for run in block["runs"]:
            cfg = _model(run["model"])
            mode = run.get("mode", "train")
            if mode == "raises":
                try:
                    dt.initialize(cfg, dict(run["config"]), device="cpu",
                                  mesh=mesh)
                    out[run["name"]] = None
                except (NotImplementedError, ValueError) as e:
                    out[run["name"]] = f"{type(e).__name__}: {e}"
                continue
            if mode == "elastic":
                from deepspeed_tpu_torch.elasticity import elastic_resume
                eng, agent, tag = elastic_resume(
                    cfg, dict(run["config"]), run["dir"], world_size=world,
                    device="cpu")
                agent.uninstall()
                out[run["name"]] = {
                    "tag": tag, "loaded": _np(eng.gathered_params()),
                    "losses": [float(eng.train_batch(iter(s)))
                               for s in run["steps"]]}
                continue
            perm = run.get("perm")
            saved_perm = tm.rts_permutation
            if perm is not None:
                tm.rts_permutation = lambda seed, s, device: \
                    torch.as_tensor(perm, device=device)
            seen = []
            inner = _count_drops(tm, seen)
            try:
                eng = dt.initialize(cfg, dict(run["config"]),
                                    params=run.get("params"), device="cpu",
                                    mesh=mesh)[0]
                res = {}
                if mode == "load":
                    res["tag"] = eng.load_checkpoint(run["dir"])[0]
                    res["params"] = _np(eng.gathered_params())
                    res["opt"] = _np(_gathered_state(eng))
                    out[run["name"]] = res
                    continue
                losses, aux = [], []
                for step in run["steps"]:
                    losses.append(float(eng.train_batch(iter(step))))
                    aux.append(float(eng._dp_mean(
                        eng._last_metrics["aux_loss"])))
                if mode == "save":
                    eng.save_checkpoint(run["dir"])
                    res["opt"] = _np(_gathered_state(eng))
                res.update(
                    losses=losses, aux=aux,
                    params=_np(eng.gathered_params()),
                    grad_norm=eng.get_global_grad_norm(),
                    coords={a: mesh.coord(a)
                            for a in ("data", "expert", "model")},
                    local=[tuple(x.shape) for x in tree_leaves(eng.params)],
                    edim=list(eng._edim), drops=seen)
                out[run["name"]] = res
            finally:
                tm.rts_permutation = saved_perm
                tm.topk_gating_rows = inner
    return out


def _gathered_state(eng):
    """The optimizer's moment trees, each leaf whole: gathered over its
    ZeRO group (a MiCS state shard over 'data' first), then over
    'expert', 'model' and 'pipe'."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves
    from deepspeed_tpu_torch.runtime.engine import _unflatten_like
    out = {}
    for k, v in eng.opt_state.items():
        if not isinstance(v, dict):
            out[k] = v
            continue
        leaves = []
        for i, x in enumerate(tree_leaves(v)):
            d = eng._pdim[i] if eng._pdim[i] is not None else eng._sdim[i]
            if getattr(eng, "_mics", None) and eng._mics[i] and \
                    eng._odim[i] is not None:
                # MiCS: the finer state shard, over 'data' first
                x = comm.all_gather(x, "data", axis=eng._odim[i])
            if d is not None:
                x = comm.all_gather(x, eng._gax[i], axis=d)
            if eng._edim[i] is not None:
                x = comm.all_gather(x, "expert", axis=eng._edim[i])
            if eng._mdim[i] is not None:
                x = comm.all_gather(x, "model", axis=eng._mdim[i])
            if eng._pipedim[i] is not None:
                x = comm.all_gather(x, "pipe", axis=eng._pipedim[i])
            leaves.append(x)
        out[k] = _unflatten_like(v, leaves)
    return out


def ep_serving(rank, world, runs):
    """The v1 engine over ``build_mesh(**run["mesh"])``. Each run:
    {"name", "mesh", "cfg" (a DecoderConfig's fields), "params" (numpy
    tree or None: drawn from ``seed``), "config", "prompt", "new"}; a
    ValueError becomes its message. Returns the logits, the greedy
    tokens, the local expert leaf's shape and the 'expert' all-to-all
    records of one forward."""
    from deepspeed_tpu_torch.comm.comms_logger import comms_logger
    from deepspeed_tpu_torch.inference import init_inference
    from deepspeed_tpu_torch.models.convert import params_from_jax
    from deepspeed_tpu_torch.models.transformer import DecoderConfig
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    out = {}
    for run in runs:
        build_mesh(**run["mesh"])
        cfg = DecoderConfig(**run["cfg"])
        params = run.get("params")
        if params is not None:
            params = params_from_jax(params, device="cpu")
        gen = torch.Generator().manual_seed(run.get("seed", 0))
        try:
            eng = init_inference(cfg, run["config"], params=params,
                                 generator=gen, device="cpu")
        except ValueError as e:
            out[run["name"]] = str(e)
            continue
        comms_logger.enabled, comms_logger.prof_all = True, True
        comms_logger.reset()
        logits = eng.forward(run["prompt"]).numpy()
        a2a = dict(comms_logger.comms_dict.get("all_to_all", {}))
        comms_logger.enabled = False
        out[run["name"]] = {
            "logits": logits, "a2a": {k: list(v) for k, v in a2a.items()},
            "tokens": eng.generate(run["prompt"], max_new_tokens=run["new"]),
            "wg": tuple(eng.params["layers"]["moe"]["wg"].shape)}
    return out


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------

def sp_attention(rank, world, cases):
    """Ulysses and ring attention over ``build_mesh(**case["mesh"])``.
    Each case: {"name", "mesh", "fn": "ulysses" | "ring", "q", "k", "v"
    (the global [B, T, H|KvH, D] fp32 arrays), "causal"}. A rank takes
    its block of the sequence over 'seq' and of the heads over 'model',
    and returns its output block and the gradients of the global
    sum(out²) with respect to its q, k and v blocks, plus the records of
    the comms logger over one forward."""
    from deepspeed_tpu_torch.comm.comms_logger import comms_logger
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    from deepspeed_tpu_torch.parallel.ring import ring_attention
    from deepspeed_tpu_torch.parallel.ulysses import distributed_attention
    out = {}
    for case in cases:
        mesh = build_mesh(**case["mesh"])
        sp, tp = mesh.shape["seq"], mesh.shape["model"]
        s, m = mesh.coord("seq"), mesh.coord("model")

        def block(a):
            t, h = a.shape[1] // sp, a.shape[2] // tp
            return torch.from_numpy(np.ascontiguousarray(
                a[:, s * t:(s + 1) * t, m * h:(m + 1) * h])
            ).requires_grad_(True)
        q, k, v = (block(case[x]) for x in ("q", "k", "v"))
        fn = ring_attention if case["fn"] == "ring" else \
            distributed_attention
        comms_logger.enabled = True
        comms_logger.reset()
        o = fn(q, k, v, causal=case.get("causal", True))
        logged = comms_logger.bytes_by_op()
        comms_logger.enabled = False
        (o ** 2).sum().backward()
        out[case["name"]] = {"out": _np(o), "dq": _np(q.grad),
                             "dk": _np(k.grad), "dv": _np(v.grad),
                             "logged": logged,
                             "coords": (mesh.coord("data"), s, m)}
    return out


def sp_runs(rank, world, meshes):
    """``meshes``: [{"shape": build_mesh kwargs, "runs": [...]}]. Each run:
    {"name", "model": (preset, kw), "config", "params" (numpy tree),
    "steps", "mode": "train" | "raises" | "save" | "load", "dir"}.
    "train" and "save" return the losses, the gathered params and the
    rank's mesh coordinates; "save" writes a checkpoint after the steps;
    "load" loads ``dir`` and returns the gathered params and moments."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    out = {}
    for block in meshes:
        mesh = build_mesh(**block["shape"])
        for run in block["runs"]:
            cfg = _model(run["model"])
            mode = run.get("mode", "train")
            if mode == "raises":
                try:
                    dt.initialize(cfg, dict(run["config"]), device="cpu",
                                  mesh=mesh)
                    out[run["name"]] = None
                except (NotImplementedError, ValueError) as e:
                    out[run["name"]] = f"{type(e).__name__}: {e}"
                continue
            eng = dt.initialize(cfg, dict(run["config"]),
                                params=run.get("params"), device="cpu",
                                mesh=mesh)[0]
            res = {}
            if mode == "load":
                res["tag"] = eng.load_checkpoint(run["dir"])[0]
                res["params"] = _np(eng.gathered_params())
                res["opt"] = _np(_gathered_state(eng))
                out[run["name"]] = res
                continue
            res["losses"] = [float(eng.train_batch(iter(step)))
                             for step in run["steps"]]
            if mode == "save":
                eng.save_checkpoint(run["dir"])
                res["opt"] = _np(_gathered_state(eng))
            res.update(params=_np(eng.gathered_params()),
                       coords={a: mesh.coord(a)
                               for a in ("data", "seq", "model")},
                       eval=float(eng.eval_batch(iter(run["steps"][0]))))
            out[run["name"]] = res
    return out


# ---------------------------------------------------------------------------
# pipeline parallelism: the engine and the schedules over 'pipe'
# ---------------------------------------------------------------------------

def pp_runs(rank, world, meshes):
    """``meshes``: [{"shape": build_mesh kwargs, "runs": [...]}]. Each run:
    {"name", "model": (preset, kw), "config", "params" (numpy tree),
    "steps", "mode": "train" | "save" | "load" | "forward_raises", "dir"}.
    "train" and "save" return the losses, the gathered params, the eval
    loss, the ppermute bytes this rank sent during the steps, the local
    shapes of the layer leaves and the rank's mesh coordinates; "save"
    writes a checkpoint after the steps and adds the gathered moments;
    "load" loads ``dir`` and returns the gathered params and moments;
    "forward_raises" returns forward()'s error."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.comm.comms_logger import comms_logger
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    out = {}
    for block in meshes:
        mesh = build_mesh(**block["shape"])
        for run in block["runs"]:
            cfg = _model(run["model"])
            mode = run.get("mode", "train")
            eng = dt.initialize(cfg, dict(run["config"]),
                                params=run.get("params"), device="cpu",
                                mesh=mesh)[0]
            res = {}
            if mode == "forward_raises":
                try:
                    eng.forward(run["steps"][0][0])
                    out[run["name"]] = None
                except RuntimeError as e:
                    out[run["name"]] = str(e)
                continue
            if mode == "load":
                res["tag"] = eng.load_checkpoint(run["dir"])[0]
                res["params"] = _np(eng.gathered_params())
                res["opt"] = _np(_gathered_state(eng))
                out[run["name"]] = res
                continue
            comms_logger.enabled, comms_logger.prof_all = True, True
            comms_logger.reset()
            res["losses"] = [float(eng.train_batch(iter(step)))
                             for step in run["steps"]]
            res["sent"] = comms_logger.bytes_by_op().get("ppermute", 0)
            comms_logger.enabled = False
            if mode == "save":
                eng.save_checkpoint(run["dir"])
                res["opt"] = _np(_gathered_state(eng))
            res.update(params=_np(eng.gathered_params()),
                       coords={a: mesh.coord(a)
                               for a in ("pipe", "data", "model")},
                       local_layers=[tuple(x.shape) for x in
                                     tree_leaves(eng.params["layers"])],
                       eval=float(eng.eval_batch(iter(run["steps"][0]))))
            out[run["name"]] = res
    return out


def pp_grads(rank, world, cases):
    """The two schedules as functions at pipe ``world``: each case
    {"name", "model": (preset, kw), "params" (numpy tree), "tokens",
    "labels" ([M, B, T])} → for "gpipe" and "1f1b" the loss and the
    gradients of every leaf, whole (the layer rows gathered over 'pipe',
    the other leaves' parts summed over it)."""
    import torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    from deepspeed_tpu_torch.runtime.engine import _unflatten_like
    from deepspeed_tpu_torch.runtime.pipe import (
        pipelined_loss, pipelined_loss_and_grads_1f1b)
    build_mesh(pipe=world)
    out = {}
    for case in cases:
        cfg = _model(case["model"])

        def conv(path, a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if path[0] == "layers":
                n = t.shape[0] // world
                t = t[rank * n:(rank + 1) * n].clone()
            return t.requires_grad_(t.is_floating_point())

        def walk(tree, path=()):
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            return conv(path, tree)
        params = walk(case["params"])
        names = list(_paths(params))
        tok = torch.from_numpy(case["tokens"])
        lab = torch.from_numpy(case["labels"])
        leaves = tree_leaves(params)
        share = pipelined_loss(cfg, params, tok, lab, remat_policy="full",
                               num_stages=world)
        g_gpipe = torch.autograd.grad(share, leaves, allow_unused=True)
        l_gpipe = comm.all_reduce(share.detach(), "pipe")
        l_1f1b, g_tree = pipelined_loss_and_grads_1f1b(
            cfg, params, tok, lab, remat_policy="full", num_stages=world)
        res = {"names": names}
        for key, loss, grads in (("gpipe", l_gpipe, g_gpipe),
                                 ("1f1b", l_1f1b, tree_leaves(g_tree))):
            whole = []
            for name, x, g in zip(names, leaves, grads):
                g = torch.zeros_like(x) if g is None else g.float()
                if name.startswith("layers/"):
                    g = comm.all_gather(g.contiguous(), "pipe", axis=0)
                else:
                    g = comm.all_reduce(g.contiguous(), "pipe")
                whole.append(g)
            res[key] = {"loss": float(loss),
                        "grads": _np(_unflatten_like(params, whole))}
        out[case["name"]] = res
    return out

# ---------------------------------------------------------------------------
# the 1-bit compressed all-reduce and optimizers, MiCS, multi-slice meshes
# ---------------------------------------------------------------------------

def compressed(rank, world, cases, slice_ids):
    """``compressed_allreduce`` over 'data' for each case {"xs", "we",
    "se" ([world, ...] numpy, position p takes row p), "steps"}, on the
    plain rank layout and on a hybrid one (``slice_ids``, dcn over
    'data') whose positions are not the ranks' order. Returns per layout
    this rank's position, each case's outputs (one a step), final error
    buffers, and the comms logger's bytes."""
    from deepspeed_tpu_torch.comm import compressed as C
    from deepspeed_tpu_torch.comm.comms_logger import comms_logger
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    out = {}
    for lay, kw in (("flat", {}), ("hybrid", {"slice_ids": slice_ids,
                                               "dcn": {"data": 2}})):
        mesh = build_mesh(data=world, **kw)
        p = mesh.coord("data")
        res = {"pos": p}
        for name, c in cases.items():
            x = torch.from_numpy(c["xs"][p])
            we = torch.from_numpy(c["we"][p])
            se = torch.from_numpy(c["se"][p])
            comms_logger.enabled, comms_logger.prof_all = True, True
            comms_logger.reset()
            outs = []
            for _ in range(c.get("steps", 1)):
                o, we, se = C.compressed_allreduce(x, we, se, "data")
                outs.append(o)
            res[name] = {"out": torch.stack(outs), "we": we, "se": se,
                         "bytes": comms_logger.bytes_by_op()}
            comms_logger.enabled = False
        out[lay] = res
    return _np(out)


def onebit_runs(rank, world, runs):
    """Each run: {"name", "model": (preset, kw), "config", "params", "steps"
    (global batches), "snaps" (step counts), "saves" (step counts),
    "mode": "train" | "save" | "load" | "raises", "dir"}. "train"/"save":
    losses, the params and the optimizer state (the error buffers this
    rank's rows) at the end and after each of "snaps" steps
    (``res["snaps"][k]``), the bytes of each op; after each of "saves"
    steps a checkpoint in ``dir/<name>_<k>``; "save" then writes ``dir``;
    "load" loads ``dir`` and returns the params and state, then trains on
    "steps"."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.comm.comms_logger import comms_logger
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    mesh = build_mesh(data=world)
    out = {}
    for run in runs:
        cfg = _model(run["model"])
        mode = run.get("mode", "train")
        if mode == "raises":
            try:
                dt.initialize(cfg, dict(run["config"]), device="cpu",
                              mesh=mesh)
                out[run["name"]] = None
            except (ValueError, RuntimeError) as e:
                out[run["name"]] = str(e)
            continue
        eng = dt.initialize(cfg, dict(run["config"]), params=run.get(
            "params"), device="cpu", mesh=mesh)[0]
        res = {}
        if mode == "load":
            res["tag"] = eng.load_checkpoint(run["dir"])[0]
            res["loaded"] = _np(dict(eng.opt_state))
            res["loaded_params"] = _np(eng.params)
        comms_logger.enabled, comms_logger.prof_all = True, True
        comms_logger.reset()
        res["losses"], res["snaps"] = [], {}
        for i, s in enumerate(run["steps"]):
            res["losses"].append(float(eng.train_batch(iter(s))))
            if i + 1 in run.get("snaps", ()):
                res["snaps"][i + 1] = {"opt": _np(dict(eng.opt_state)),
                                       "params": _np(eng.params)}
            if i + 1 in run.get("saves", ()):
                comms_logger.enabled = False
                eng.save_checkpoint(f"{run['dir']}/{run['name']}_{i + 1}")
                comms_logger.enabled = True
        res["bytes"] = comms_logger.bytes_by_op()
        comms_logger.enabled = False
        res["params"] = _np(eng.params)
        res["opt"] = _np(dict(eng.opt_state))
        if mode == "save":
            eng.save_checkpoint(run["dir"])
        if run.get("forward"):
            try:
                eng.forward(run["steps"][0][0])
            except RuntimeError as e:
                res["forward"] = str(e)
        out[run["name"]] = res
    return out


def mics_runs(rank, world, runs, slice_ids):
    """MiCS and the multi-slice layouts at world 4.

    ``runs``: [{"name", "mesh" (build_mesh kwargs, "slice_ids": True for
    ``slice_ids``), "model", "config", "params", "steps", "mode": "train"
    | "save" | "load", "dir"}] → losses, gathered params and moments, the
    local shapes, the all-gather bytes by axis of one step. Also: the
    rank arrays and positions of hybrid meshes, collectives over a
    hybrid mesh whose positions are not the ranks' order, a mesh over a
    subset of the ranks, and build_mesh's validation errors."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.comm.comms_logger import comms_logger
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    out = {"layouts": {}, "errors": {}}
    for name, kw in (("data_x_inner", dict(data=2, data_inner=2,
                                           dcn={"data": 2})),
                     ("auto_pipe", dict(pipe=2, data=2)),
                     ("auto_data", dict(data=4)),
                     ("inner_dcn", dict(data=2, data_inner=2,
                                        dcn={"data_inner": 2}))):
        m = build_mesh(slice_ids=slice_ids, **kw)
        out["layouts"][name] = {"devices": m.devices.copy(),
                                "coords": dict(m.coords)}
    # collectives over the hybrid mesh (positions: [0, 2 | 1, 3] on data)
    hm = build_mesh(data=4, slice_ids=slice_ids, dcn={"data": 2})
    p = hm.coord("data")
    x = torch.arange(8, dtype=torch.float32) + 10 * p
    out["hybrid"] = {
        "pos": p, "index": comm.axis_index("data"),
        "sum": comm.all_reduce(x, "data"),
        "gather": comm.all_gather(x[:2], "data"),
        "rs": comm.reduce_scatter(x, "data"),
        "a2a": comm.all_to_all(x, "data", split_axis=0, concat_axis=0),
        "next": comm.send_recv_next(x[:1], "data", 4)}
    # the expert-parallel exchanges and their backwards on the same axis:
    # the rank at position p weighs block j of what it got by 10p + j + 1
    w = 10.0 * p + torch.arange(4, dtype=torch.float32)[:, None] + 1
    for name, fn, arg, wt in (
            ("ep_exchange", comm.expert_exchange, x.reshape(4, 2), w),
            ("ep_scatter", comm.scatter_to_experts, x.reshape(4, 2), w[:1]),
            ("ep_gather", comm.gather_from_experts, x[:2].reshape(1, 2),
             w)):
        xi = arg.clone().requires_grad_(True)
        y = fn(xi, "data")
        (y.reshape(-1, 2) * wt).sum().backward()
        out["hybrid"][name] = y.detach()
        out["hybrid"][name + "_grad"] = xi.grad
    im = build_mesh(data=2, data_inner=2, slice_ids=slice_ids,
                    dcn={"data": 2})
    out["hybrid"]["psum_pair"] = comm.all_reduce(
        torch.tensor([float(im.index(("data", "data_inner")))]),
        ("data", "data_inner"))
    # a mesh over ranks 0 and 1: they hold its group; 2 and 3 are not in it
    sub = build_mesh(data=2, devices=[0, 1])
    out["sub"] = {"member": sub.member}
    if sub.member:
        out["sub"]["sum"] = float(comm.all_reduce(
            torch.tensor([float(rank + 1)]), "data"))
    for name, kw in (("multiply", dict(data=4, dcn={"data": 4},
                                       slice_ids=slice_ids)),
                     ("divisible", dict(data=1, model=4, dcn={"data": 2},
                                        slice_ids=slice_ids)),
                     ("uneven", dict(data=4, dcn={"data": 2},
                                     slice_ids=[0, 0, 0, 1])),
                     ("one_slice", dict(data=4, dcn={"data": 2},
                                        slice_ids=[0] * 4)),
                     ("pass_dcn", dict(data=1, model=4,
                                       slice_ids=[0, 0, 1, 1]))):
        try:
            build_mesh(**kw)
        except ValueError as e:
            out["errors"][name] = str(e)
    for run in runs:
        kw = dict(run["mesh"])
        if kw.pop("slice_ids", False):
            kw["slice_ids"] = slice_ids
        mesh = build_mesh(**kw)
        eng = dt.initialize(_model(run["model"]), dict(run["config"]),
                            params=run.get("params"), device="cpu",
                            mesh=mesh)[0]
        res = {"local": [tuple(t.shape) for t in tree_leaves(eng.params)]}
        if run.get("mode") == "load":
            res["tag"] = eng.load_checkpoint(run["dir"])[0]
            res["loaded"] = _np(eng.gathered_params())
            res["loaded_opt"] = _np(_gathered_state(eng))
        comms_logger.enabled, comms_logger.prof_all = True, True
        losses = []
        for i, step in enumerate(run["steps"]):
            comms_logger.reset()
            losses.append(float(eng.train_batch(iter(step))))
            if i == 0:
                res["gather_bytes"] = {
                    str(k[1]): v for k, v in
                    comms_logger.bytes_by_axis().items()
                    if k[0] == "all_gather"}
        comms_logger.enabled = False
        res.update(losses=losses, params=_np(eng.gathered_params()),
                   opt=_np(_gathered_state(eng)))
        if run.get("mode") == "save":
            eng.save_checkpoint(run["dir"])
        out[run["name"]] = res
    return _np(out)

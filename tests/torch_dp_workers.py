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
    for ax in ("model", "seq", "pipe", "expert", "data_inner"):
        try:
            M.build_mesh(data=world // 2, **{ax: 2})
        except NotImplementedError as e:
            raises[ax] = str(e)
    out["raises"] = raises
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
        if run.get("layout"):
            res["layout"] = {"pdim": eng._pdim, "sdim": eng._sdim,
                             "gdim": eng._gdim,
                             "local": [tuple(x.shape) for x in
                                       tree_leaves(eng.params)]}
        out[run["name"]] = res
    return out


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

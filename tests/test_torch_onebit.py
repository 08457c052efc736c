"""The port's 1-bit Adam, 1-bit LAMB and 0/1 Adam (deepspeed_tpu_torch/
ops/onebit.py) at data 2 and 4 — gloo ranks on the CPU (tests/torch_dp.py)
— against ``deepspeed_tpu.initialize`` on ``build_mesh(data=n)`` over n
CPU devices, from one numpy parameter tree and tests/test_onebit.py's
setup (on Llama: a key bias's gradient is rounding noise, which Adam
scales to ±lr a step, so gpt2's would differ between any two reduction
orders): llama3-tiny (T 32, vocabulary 128) fp32, one global batch of 8
rows trained on at every step, stage 0.

Runs: 1-bit Adam over ``freeze_step`` 3 (three exact warmup steps, then
three compressed ones), 1-bit LAMB over the same, 0/1 Adam with
``var_freeze_step`` 4 (exact variance steps 1, 2, 4, a 1-bit one at 3)
then local steps syncing at 5, 6, 7 and, the interval doubled, at 8 and
10 but not 9; AdamW beside them. Checkpoints of 1-bit Adam at data 2
cross the packages in both directions (the error buffers as each rank's
rows).

Every run takes Adam's eps at 1e-3 (``OPTS``: the step divides the
momentum by sqrt(v) + eps, which at a tiny eps amplifies last-bit
differences of the two packages' sums into whole steps).

Tolerances: the port is held to the JAX engine elementwise — losses
within 1e-5 relative, state and parameters within 2e-5 absolute — from
one starting state over one or two steps at a time: from the initial
tree through the FIRST compressed exchange, and from the port's
checkpoints (``CONTINUE``), which the JAX engine loads, over the steps
after them — 1-bit Adam's and 1-bit LAMB's second compressed step (the
error buffers live), and 0/1 Adam's last variance step with its first
local step and sync, and a local step without a sync followed by one
with it (the undone drift, the averaged momentum, the u and lrs resets).
A compressed step's compensated value that lay within rounding of zero
takes the sign (and so the ±scale) that the two packages' summation
orders decide apart: such elements of ``m`` (at most 1e-3 of them) and
the state and parameters they moved are left out of that step's
comparison, and every other element is held; a step without a
compressed exchange leaves none out. Over a longer run those signs move
later gradients, so the rest is held through the counters, the interval
policy and the frozen coefficients (exact), and the port's own falling
loss. Loaded checkpoints are bitwise.
"""

import threading

import jax
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.models.llama import llama3_config as j_llama
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.parallel import mesh as jmesh

import deepspeed_tpu_torch as dt
from torch_dp import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

VOCAB, SEQ, GB = 128, 32, 8
KW = {"max_seq_len": SEQ, "vocab_size": VOCAB}
LLAMA = ("llama3_config", KW)
#: eps 1e-3 on every run: the step divides the momentum by sqrt(v) +
#: eps, and where v is tiny a difference in the last bits of m (a sum in
#: another order; after the freeze, a server scale) is amplified up to
#: lr / eps-fold — at 1e-8 an entry whose gradient is rounding noise moves
#: by ±lr on the noise's sign
OPTS = {
    "adamw": ({"type": "adamw", "params": {"lr": 5e-3, "eps": 1e-3,
                                           "weight_decay": 0.0}}, 6),
    "onebitadam": ({"type": "onebitadam",
                    "params": {"lr": 5e-3, "eps": 1e-3,
                               "freeze_step": 3}}, 6),
    "onebitlamb": ({"type": "onebitlamb",
                    "params": {"lr": 5e-3, "eps": 1e-3,
                               "freeze_step": 3}}, 6),
    "zerooneadam": ({"type": "zerooneadam",
                     "params": {"lr": 2e-3, "eps": 1e-3,
                                "var_freeze_step": 4,
                                "var_update_scaler": 2,
                                "local_step_scaler": 3,
                                "local_step_clipper": 2}}, 10),
}
#: the steps through the first compressed exchange: held to JAX
SNAP = {"adamw": 6, "onebitadam": 4, "onebitlamb": 4, "zerooneadam": 3}
#: the port saves after step k, the JAX engine loads that save, and both
#: are held after each of the next steps: k → those steps
CONTINUE = {"onebitadam": {4: (5,)}, "onebitlamb": {4: (5,)},
            "zerooneadam": {3: (4, 5), 8: (9, 10)}}
#: the continued steps that make no compressed exchange (0/1 Adam's exact
#: variance step, and its local step without a sync)
UNCOMPRESSED = {("zerooneadam", 4), ("zerooneadam", 9)}
CKPT = ({"type": "onebitadam", "params": {"lr": 5e-3, "eps": 1e-3,
                                          "freeze_step": 2}}, 4)
COUNTERS = ("step", "var_interval", "var_counter", "local_interval",
            "local_counter", "exact_comms", "onebit_comms")


def _config(opt, world):
    return {"train_micro_batch_size_per_gpu": GB // world,
            "optimizer": opt, "zero_optimization": {"stage": 0}}


def _batch():
    rng = np.random.default_rng(42)
    return {"input_ids": rng.integers(0, VOCAB, size=(GB, SEQ),
                                      dtype=np.int32)}


def _steps(n):
    return [[_batch()] for _ in range(n)]


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def _per_device(x):
    """Every device's own value of a JAX array, in device order: 0/1
    Adam's local steps leave each device's "replicated" state its own."""
    return [np.asarray(sh.data) for sh in
            sorted(x.addressable_shards, key=lambda sh: sh.device.id)]


def _jax_continue(world, opt, init, ckpts):
    """The JAX engine from each of the port's checkpoints ``ckpts`` ({k:
    (dir, steps)}): after each further step its loss, and every device's
    optimizer state and params."""
    jmesh.build_mesh(data=world, devices=jax.devices()[:world])
    je, *_ = deepspeed_tpu.initialize(model=j_llama("tiny", **KW),
                                      config=_config(opt, world),
                                      params=init)
    out = {}
    for k, (path, steps) in ckpts.items():
        assert je.load_checkpoint(path)[0] is not None
        for step, s in zip(steps, _steps(len(steps))):
            out[step] = {
                "loss": float(je.train_batch(iter(s))),
                "opt": {n: _per_device(v) for n, v in je.opt_state.items()},
                "params": jax.tree.map(_per_device, je.params)}
    return out


def _jax_run(world, opt, steps, init, load=None, snap=None):
    jmesh.build_mesh(data=world, devices=jax.devices()[:world])
    je, *_ = deepspeed_tpu.initialize(model=j_llama("tiny", **KW),
                                      config=_config(opt, world),
                                      params=init)
    out = {"losses": []}
    if load is not None:
        out["tag"] = je.load_checkpoint(load)[0]
        out["loaded"] = _np_tree(je.opt_state)
        out["loaded_params"] = _np_tree(je.params)
    for i, s in enumerate(_steps(steps)):
        out["losses"].append(float(je.train_batch(iter(s))))
        if i + 1 == snap:
            out["snap"] = {"opt": _np_tree(je.opt_state),
                           "params": _np_tree(je.params)}
    out["opt"] = _np_tree(je.opt_state)
    out["params"] = _np_tree(je.params)
    return je, out


@pytest.fixture(scope="module")
def init():
    return _np_tree(j_init(j_llama("tiny", **KW), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def runs(init, tmp_path_factory):
    """The JAX checkpoint run first (the port loads it), then the port's
    ranks at data 2 and 4 in the background while the JAX references
    run here; last, the JAX engine loads the port's checkpoint."""
    root = str(tmp_path_factory.mktemp("onebit"))
    saved = jmesh._CURRENT_MESH
    jax_out, port = {2: {}, 4: {}}, {}
    threads = []
    try:
        je, jax_out[2]["ckpt"] = _jax_run(2, CKPT[0], CKPT[1], init)
        je.save_checkpoint(root + "/jax")
        del je
        jobs = {}
        for world in (2, 4):
            rr = [{"name": name, "model": LLAMA, "params": init,
                   "config": _config(opt, world), "steps": _steps(n),
                   "snaps": (SNAP[name],) + tuple(
                       t for steps in CONTINUE.get(name, {}).values()
                       for t in steps),
                   "saves": tuple(CONTINUE.get(name, ())),
                   "dir": f"{root}/port{world}",
                   "forward": name == "onebitadam"}
                  for name, (opt, n) in OPTS.items()]
            if world == 2:
                rr += [{"name": "save", "model": LLAMA, "params": init,
                        "config": _config(CKPT[0], 2),
                        "steps": _steps(CKPT[1]), "mode": "save",
                        "dir": root + "/port"},
                       {"name": "load", "model": LLAMA, "params": init,
                        "config": _config(CKPT[0], 2), "steps": _steps(2),
                        "mode": "load", "dir": root + "/jax"}]
            jobs[world] = rr

        def job(world, rr):
            try:
                port[world] = spawn("onebit_runs", world, timeout=300.0,
                                    runs=rr)
            except BaseException as e:          # noqa: BLE001 — re-raised
                port[world] = e
        threads = [threading.Thread(target=job, args=kv)
                   for kv in jobs.items()]
        for t in threads:
            t.start()
        for world in (2, 4):
            for name, (opt, n) in OPTS.items():
                jax_out[world][name] = _jax_run(world, opt, n, init,
                                                snap=SNAP[name])[1]
        # the JAX engine after the port's load: two more steps
        jax_out[2]["load"] = _jax_run(2, CKPT[0], 2, init,
                                      load=root + "/jax")[1]
    finally:
        for t in threads:
            t.join()
    try:
        for world in (2, 4):
            if isinstance(port[world], BaseException):
                raise port[world]
        jax_out[2]["port_save"] = _jax_run(2, CKPT[0], 0, init,
                                           load=root + "/port")[1]
        for world in (2, 4):
            for name, ckpts in CONTINUE.items():
                jax_out[world]["continue_" + name] = _jax_continue(
                    world, OPTS[name][0], init, {
                        k: (f"{root}/port{world}/{name}_{k}", steps)
                        for k, steps in ckpts.items()})
    finally:
        jmesh._CURRENT_MESH = saved
    return {"jax": jax_out, "port": port}


def _flat(tree, order):
    """The tree's leaves flattened in ``order`` (the JAX flat order: its
    sorted key paths) into one vector."""
    lv = _leaves(tree)
    return np.concatenate([np.asarray(lv[k], np.float64).reshape(-1)
                           for k in order])


def _hold_state(go, jo, gp, jp, what, compressed=True):
    """One rank's optimizer state ``go`` and flat params ``gp`` against
    the JAX engine's ``jo`` (its error buffers cut to this rank's row)
    and ``jp``, after one step from a common state; the elements whose
    compressed sign the packages decided apart are left out (none, for a
    step without a compressed exchange)."""
    assert sorted(jo) == sorted(go), (sorted(jo), sorted(go))
    dm = np.abs(go["m"].astype(np.float64) - jo["m"])
    flip = dm > 2e-5
    limit = 1e-3 * flip.size if compressed else 0
    assert flip.sum() <= limit, (what, int(flip.sum()))
    for k in ("v", "u"):
        if go[k].size:
            np.testing.assert_allclose(go[k][~flip], jo[k][~flip], rtol=0,
                                       atol=2e-5, err_msg=f"{what} {k}")
    for a, b in ((go["master"], jo["master"]), (gp, jp)):
        np.testing.assert_allclose(a[~flip], b[~flip], rtol=0, atol=2e-5,
                                   err_msg=what)
    np.testing.assert_allclose(go["coeff"], jo["coeff"], rtol=1e-5,
                               atol=1e-6, err_msg=what)
    np.testing.assert_allclose(go["lrs"], jo["lrs"], rtol=1e-6,
                               err_msg=what)
    for k in ("werr", "serr"):
        assert go[k].shape == jo[k].shape, (what, k)
        close = np.abs(go[k] - jo[k]) <= 2e-5
        assert close.mean() >= (1 - 1e-3 if compressed else 1), (
            what, k, close.mean())
    for k in COUNTERS:
        assert int(go[k]) == int(jo[k]), (what, k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_onebit_matches_jax_engine(runs, world, name):
    """Through the first compressed exchange: losses, the optimizer state
    and the parameters against the JAX engine on a data mesh of the same
    size, but for the elements whose compressed sign was decided by
    rounding; at the end, the counters and the coefficients. Every rank
    reports the same losses and holds the same parameters."""
    want = runs["jax"][world][name]
    res = runs["port"][world]
    n = SNAP[name]
    for r in range(world):
        got = res[r][name]
        assert got["losses"] == res[0][name]["losses"]
        np.testing.assert_allclose(got["losses"][:n], want["losses"][:n],
                                   rtol=1e-5, err_msg=f"{name} {r}")
        gs, js = got["snaps"][n], want["snap"]
        order = sorted(_leaves(js["params"]))
        assert order == sorted(_leaves(gs["params"]))
        gp, jp = _flat(gs["params"], order), _flat(js["params"], order)
        if name == "adamw":
            np.testing.assert_allclose(gp, jp, rtol=0, atol=2e-5)
            continue
        jo = dict(js["opt"], werr=js["opt"]["werr"][r:r + 1],
                  serr=js["opt"]["serr"][r:r + 1])
        _hold_state(gs["opt"], jo, gp, jp, f"{name} rank {r}")
        fo, jf = got["opt"], want["opt"]
        for k in COUNTERS:
            assert int(fo[k]) == int(jf[k]), (name, k)
        np.testing.assert_allclose(fo["coeff"], jf["coeff"], rtol=1e-5,
                                   atol=1e-6)


STEPS_ON = [(name, t) for name, ckpts in CONTINUE.items()
            for steps in ckpts.values() for t in steps]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name,step", STEPS_ON,
                         ids=[f"{n}-step{t}" for n, t in STEPS_ON])
def test_onebit_continues_like_jax_from_one_checkpoint(runs, world, name,
                                                       step):
    """From the port's checkpoint, loaded by the JAX engine: the loss of
    each later step, and every rank's state and parameters after it —
    1-bit Adam's and LAMB's compressed step with live error buffers, and
    0/1 Adam's variance step, local steps and syncs — against that
    rank's device of the JAX engine."""
    want = runs["jax"][world]["continue_" + name][step]
    for r in range(world):
        got = runs["port"][world][r][name]
        what = f"{name} step {step} rank {r}"
        np.testing.assert_allclose(got["losses"][step - 1], want["loss"],
                                   rtol=1e-5, err_msg=what)
        gs = got["snaps"][step]
        jparams = jax.tree.map(lambda x: x[r], want["params"],
                               is_leaf=lambda x: isinstance(x, list))
        order = sorted(_leaves(jparams))
        assert order == sorted(_leaves(gs["params"]))
        _hold_state(gs["opt"], {k: v[r] for k, v in want["opt"].items()},
                    _flat(gs["params"], order), _flat(jparams, order), what,
                    compressed=(name, step) not in UNCOMPRESSED)


def test_onebit_warmup_is_adam_and_compressed_phase_trains(runs):
    """During the warmup 1-bit Adam IS Adam (its losses AdamW's); after
    the freeze the error buffers are live, the loss stays below the
    first step's, and the
    compressed exchange moved n // 8 + 4 bytes a step where the fp32
    all-reduce moves 4n."""
    for world in (2, 4):
        for r in range(world):
            res = runs["port"][world][r]
            a, b = res["adamw"], res["onebitadam"]
            np.testing.assert_allclose(b["losses"][:3], a["losses"][:3],
                                       rtol=1e-5)
            assert np.isfinite(b["losses"]).all()
            assert b["losses"][-1] < b["losses"][0]
            assert np.abs(b["opt"]["werr"]).sum() > 0
            assert np.abs(b["opt"]["serr"]).sum() > 0
            n = b["opt"]["master"].size
            padded = b["opt"]["werr"].shape[1]
            assert padded % (8 * world) == 0 and padded - n < 8 * world
            assert b["bytes"]["compressed_allreduce"] == 3 * (
                padded // 8 + 4)
            # three warmup all-reduces of the fp32 gradient (4n bytes),
            # plus six of the 4-byte loss
            assert b["bytes"]["all_reduce"] == 3 * 4 * n + 6 * 4


def test_onebit_lamb_freezes_its_coefficients(runs):
    """1-bit LAMB: the per-leaf trust-ratio EMA moved off 1.0 in the
    warmup, stays within [min_coeff, max_coeff] and equals the JAX one
    (exact per-leaf norms over the whole replicated leaf)."""
    for world in (2, 4):
        want = runs["jax"][world]["onebitlamb"]["opt"]["coeff"]
        for r in range(world):
            c = runs["port"][world][r]["onebitlamb"]["opt"]["coeff"]
            assert np.abs(c - 1.0).max() > 1e-3
            assert (c >= 0.01 - 1e-9).all() and (c <= 10.0 + 1e-9).all()
            np.testing.assert_allclose(c, want, rtol=1e-5, atol=1e-6)


def test_zeroone_interval_policy_and_local_steps(runs):
    """0/1 Adam: exact variance steps 1, 2, 4 and a 1-bit one at 3 (the
    interval doubled after two variance updates); after var_freeze_step
    4 local steps sync at 5, 6, 7 (interval 1) and, the interval doubled
    at the third local step, at 8 and 10 but not 9; the accumulator u is
    param-sized."""
    for world in (2, 4):
        for r in range(world):
            st = runs["port"][world][r]["zerooneadam"]["opt"]
            assert int(st["var_interval"]) == 2
            assert int(st["exact_comms"]) == 3
            assert int(st["onebit_comms"]) == 1 + 5
            assert int(st["local_interval"]) == 2
            assert st["u"].shape == st["master"].shape


def test_onebit_checkpoints_cross_the_packages(runs):
    """The port's save (data 2, after the freeze) loads into the JAX
    engine bitwise — its error buffers assembled from the ranks' rows —
    and the JAX engine's save loads into the port bitwise; both then
    train on alike."""
    port = runs["port"][2]
    jl = runs["jax"][2]["port_save"]
    assert jl["tag"] is not None
    for r in range(2):
        saved = port[r]["save"]
        for k, v in saved["opt"].items():
            want = np.asarray(jl["loaded"][k])
            if k in ("werr", "serr"):
                want = want[r:r + 1]
            np.testing.assert_array_equal(v, want, err_msg=k)
        for k, v in _leaves(saved["params"]).items():
            np.testing.assert_array_equal(
                _leaves(jl["loaded_params"])[k], v, err_msg=k)
    jax_saved = runs["jax"][2]["ckpt"]
    for r in range(2):
        got = port[r]["load"]
        assert got["tag"] is not None
        for k, v in got["loaded"].items():
            want = np.asarray(jax_saved["opt"][k])
            if k in ("werr", "serr"):
                want = want[r:r + 1]
            np.testing.assert_array_equal(v, want, err_msg=k)
        for k, v in _leaves(got["loaded_params"]).items():
            np.testing.assert_array_equal(
                v, _leaves(jax_saved["params"])[k], err_msg=k)
        np.testing.assert_allclose(got["losses"],
                                   runs["jax"][2]["load"]["losses"],
                                   rtol=1e-4)


def test_onebit_rejections_match_jax():
    """The JAX validate_onebit's refusals (stage, fp16, offload) with its
    words; forward() raises as under a pipeline; the optimizer names
    match with '-' and '_' ignored."""
    from deepspeed_tpu_torch.ops.onebit import is_onebit
    for name in ("OneBitAdam", "onebit-lamb", "zero_one_adam",
                 "zerooneadam", "onebit_adam"):
        assert is_onebit(name), name
    assert not is_onebit("adamw") and not is_onebit("lamb")
    cfg = dt.llama3_config("tiny", **KW)
    opt = {"type": "onebitadam", "params": {"lr": 1e-3}}
    saved = jmesh._CURRENT_MESH
    try:
        jmesh.build_mesh(data=1, devices=jax.devices()[:1])
        for extra in ({"zero_optimization": {"stage": 2}},
                      {"fp16": {"enabled": True}},
                      {"zero_optimization": {"stage": 0, "offload_optimizer": {
                          "device": "cpu"}}}):
            conf = dict({"train_micro_batch_size_per_gpu": 1,
                         "optimizer": opt}, **extra)
            with pytest.raises(ValueError) as want:
                deepspeed_tpu.initialize(model=j_llama("tiny", **KW),
                                         config=conf)
            with pytest.raises(ValueError) as got:
                dt.initialize(cfg, conf, device="cpu")
            assert str(got.value) == str(want.value)
    finally:
        jmesh._CURRENT_MESH = saved


def test_onebit_forward_raises(runs):
    for world in (2, 4):
        for rr in runs["port"][world]:
            assert "use train_batch()" in rr["onebitadam"]["forward"]

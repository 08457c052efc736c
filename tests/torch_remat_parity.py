"""Shared harness of the remat-policy parity tests
(``test_torch_remat.py``, ``test_torch_remat_offload.py``): the port's
engine and the JAX engine trained from one numpy tree of
``llama3_config("tiny")`` at 2 layers, on the same batches, under one
``activation_checkpointing`` block.

Config: SGD with momentum (lr 0.1: its update is linear in the
gradients, so the parameters after 4 steps hold the gradients to the
tolerance; Adam's ~lr x sign(m) update on a gradient at rounding level
would hold only the optimizer), micro batch 2 x T 64, gas 1, 4 steps. A policy that keeps
the flash kernel's residuals (``attn_kernel_out``/``attn_lse``) runs with
``attention_impl: "pallas_flash"`` (the JAX side runs its Pallas flash
forward and backward in interpret mode, where those names exist; the
port runs the plain versions of K1 and K3 through the kernels' wrapper);
every other policy with "naive" attention, whose compile costs the JAX
side half as much. Tolerances: losses 1e-5
relative and parameters 1e-5 absolute against the JAX engine (fp32 on
both sides, summation order alone differs), and 1e-6 against the port's
own 'none' run (the same arithmetic replayed).
"""

import jax
import numpy as np

import deepspeed_tpu
from deepspeed_tpu.models.llama import llama3_config as jax_llama3
from deepspeed_tpu.models.transformer import init_params as jax_init
from deepspeed_tpu.parallel import mesh as jax_mesh

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models.convert import params_to_numpy

MICRO, SEQ, STEPS, LAYERS = 2, 64, 4, 2
CONFIG = {
    "train_micro_batch_size_per_gpu": MICRO,
    "gradient_accumulation_steps": 1,
    "optimizer": {"type": "sgd", "params": {"lr": 0.1, "momentum": 0.9}},
    "attention_impl": "pallas_flash",
    "seed": 3,
}
#: the policies that name the flash kernel's residuals, alone or through
#: cpu_checkpointing's upgrade of save_attn_kernel
KERNEL_POLICIES = ("save_attn_kernel", "save_attn_kernel_moe_glu",
                   "save_attn_kernel_qkv", "offload_save_attn_kernel",
                   "offload_save_attn_kernel_host")


def setup():
    """(numpy init tree, batches)."""
    cfg = jax_llama3("tiny", num_layers=LAYERS)
    init = jax.tree.map(lambda x: np.asarray(jax.device_get(x)),
                        jax_init(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    data = [{"input_ids": rng.integers(0, cfg.vocab_size, size=(MICRO, SEQ))
             .astype(np.int32)} for _ in range(STEPS)]
    return init, data


def impl_of(ac) -> str:
    """The attention the parity run of ``ac`` takes."""
    return "pallas_flash" if ac.get("policy") in KERNEL_POLICIES \
        else "naive"


def _config(ac, impl=None):
    return dict(CONFIG, attention_impl=impl or impl_of(ac),
                activation_checkpointing=dict(ac))


def run_jax(init, data, ac):
    """Losses and final params of the JAX engine under ``ac`` (and the
    attention of :func:`impl_of`)."""
    saved = jax_mesh._CURRENT_MESH
    try:
        jax_mesh.build_mesh(data=1, devices=jax.devices()[:1])
        eng, *_ = deepspeed_tpu.initialize(
            model=jax_llama3("tiny", num_layers=LAYERS),
            config=_config(ac),
            params=init)
        losses = [float(eng.train_batch(iter([d]))) for d in data]
        params = jax.tree.map(lambda x: np.asarray(jax.device_get(x)),
                              eng.params)
    finally:
        jax_mesh._CURRENT_MESH = saved
    return losses, params


def run_port(init, data, ac, impl=None):
    """Losses and final params of the port's engine under ``ac`` (with
    ``impl``'s attention, by default :func:`impl_of`'s)."""
    eng, *_ = dt.initialize(model=dt.llama3_config("tiny", num_layers=LAYERS),
                            config=_config(ac, impl), params=init,
                            device="cpu")
    losses = [float(eng.train_batch(iter([d]))) for d in data]
    return losses, params_to_numpy(eng.params)


def assert_same(got, want, rtol_loss, atol_params):
    np.testing.assert_allclose(got[0], want[0], rtol=rtol_loss)
    for path, w in jax.tree_util.tree_flatten_with_path(want[1])[0]:
        leaf = got[1]
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(leaf, w, atol=atol_params, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))

"""The offline quantizer: ``python -m deepspeed_tpu_torch.cli.dstpu_quantize``
against ``bin/dstpu_quantize`` of the JAX package, on the CPU (the
scenarios of tests/test_quantize_cli.py).

A tiny Llama is drawn by the JAX package and exported as an HF checkpoint
(fp32). Each package's quantized tree of it is written in its own tool's
npz layout and read by the other package: leaves identical, fp8 included
(stored as its bytes). The npz then serves: the port's InferenceEngine
from the npz gives the JAX engine's greedy tokens and its own tokens
under ``weight_quant`` at start-up, identical.
"""

import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.inference.engine import InferenceEngineTPU
from deepspeed_tpu.models import hf_loader as jhf
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.models.llama import llama3_config as jllama
from deepspeed_tpu.ops.quantized_linear import quantize_param_tree as jq
from deepspeed_tpu.parallel import mesh as jax_mesh

from deepspeed_tpu_torch.cli import dstpu_quantize as tcli
from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.models import hf_loader as thf
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_cli():
    spec = importlib.util.spec_from_loader("dstpu_quantize", loader=None)
    mod = importlib.util.module_from_spec(spec)
    with open(os.path.join(REPO, "bin", "dstpu_quantize")) as fh:
        exec(compile(fh.read(), "dstpu_quantize", "exec"), mod.__dict__)
    return mod


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _bytes(a) -> np.ndarray:
    """A leaf's raw bytes, whichever package holds it."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn
                else a).numpy().view(np.uint8)
    a = np.asarray(a)
    return a.view(np.uint8)


def _assert_bitwise(jtree, ttree):
    jl, tl = _flat(jtree), _flat(ttree)
    assert sorted(jl) == sorted(tl)
    for k in jl:
        assert tuple(np.shape(jl[k])) == tuple(tl[k].shape), k
        assert np.array_equal(_bytes(jl[k]), _bytes(tl[k])), k


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    saved = jax_mesh._CURRENT_MESH
    jax_mesh.build_mesh(data=1, devices=jax.devices()[:1])
    cfg = jllama("tiny", vocab_size=256, max_seq_len=64)
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    d = str(tmp_path_factory.mktemp("hf") / "llama")
    jhf.export_hf_checkpoint(cfg, params, d)
    yield d
    jax_mesh._CURRENT_MESH = saved


@pytest.mark.parametrize("mode", ["int8", "fp8", "int4"])
def test_each_package_reads_the_others_npz(hf_dir, tmp_path, mode, capsys):
    jcli = _jax_cli()
    jcfg, jp = jhf.load_hf_checkpoint(hf_dir)
    jqp = jax.tree.map(np.asarray, jq(jax.tree.map(jnp.asarray, jp),
                                      mode=mode))
    jcli.save_quantized_npz(str(tmp_path / "jax.npz"), jcfg, jqp)
    assert tcli.main(["--model-dir", hf_dir, "--mode", mode, "--out",
                      str(tmp_path / "port.npz"), "--report",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "rel_err" in out and "wrote" in out
    tcfg, from_jax = tcli.load_quantized_npz(str(tmp_path / "jax.npz"),
                                             device="cpu")
    assert tcfg.__dict__ == jcfg.__dict__
    _assert_bitwise(jqp, from_jax)
    jcfg2, from_port = jcli.load_quantized_npz(str(tmp_path / "port.npz"))
    assert jcfg2 == jcfg
    _, own = tcli.load_quantized_npz(str(tmp_path / "port.npz"),
                                     device="cpu")
    _assert_bitwise(from_port, own)
    _assert_bitwise(jqp, own)
    if mode == "fp8":
        assert own["layers"]["attn"]["wq"].dtype == torch.float8_e4m3fn


def test_npz_serves_like_startup_quantization(hf_dir, tmp_path):
    """int4 npz → the port's InferenceEngine: greedy tokens identical to
    the engine quantizing the float checkpoint at start-up and to the JAX
    engine serving the same npz."""
    path = str(tmp_path / "q4.npz")
    assert tcli.main(["--model-dir", hf_dir, "--mode", "int4", "--out", path,
                      "--device", "cpu"]) == 0
    cfg, qp = tcli.load_quantized_npz(path, device="cpu")
    assert qp["layers"]["attn"]["wq"].dtype == torch.uint8
    prompt = np.arange(1, 9, dtype=np.int32)[None].repeat(2, 0)
    got = InferenceEngine(cfg, {"dtype": "float32"}, params=qp,
                          device="cpu").generate(prompt, max_new_tokens=6)
    fcfg, fp = thf.load_hf_checkpoint(hf_dir, device="cpu")
    startup = InferenceEngine(fcfg, {"dtype": "float32",
                                     "weight_quant": "int4"}, params=fp,
                              device="cpu").generate(prompt,
                                                     max_new_tokens=6)
    jcfg, jqp = _jax_cli().load_quantized_npz(path)
    want = InferenceEngineTPU(jcfg, {"dtype": "float32"},
                              params=jqp).generate(prompt, max_new_tokens=6)
    np.testing.assert_array_equal(got, startup)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="already quantized"):
        InferenceEngine(cfg, {"dtype": "float32", "weight_quant": "int8"},
                        params=qp, device="cpu")


def test_bf16_tree_rejected(tmp_path):
    from deepspeed_tpu_torch.models.llama import llama3_config
    cfg = llama3_config("tiny")
    with pytest.raises(ValueError, match="bfloat16"):
        tcli.save_quantized_npz(str(tmp_path / "x.npz"), cfg,
                                {"w": torch.zeros(2, dtype=torch.bfloat16)})

"""BERT / DistilBERT: deepspeed_tpu_torch's masked-LM head, padded
bidirectional forward, HF load and export, EncoderInference and MLM
training against deepspeed_tpu's, on the CPU in fp32 at tiny sizes,
weights carried across by ``params_from_jax`` (the scenarios of
tests/test_bert.py).

Tolerances: fp32 logits and losses within 1e-5 relative (largest
difference over the largest value; the packages sum in other orders);
HF trees and exported files identical, byte for byte.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.inference.encoder import EncoderInferenceTPU
from deepspeed_tpu.models import hf_loader as jhf
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.models.bert import bert_config as jbert
from deepspeed_tpu.models.bert import distilbert_config as jdistil
from deepspeed_tpu.parallel import mesh as jax_mesh

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.inference import (EncoderInference,
                                           init_encoder_inference)
from deepspeed_tpu_torch.models import hf_loader as thf
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.convert import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-5
ENG = {"dtype": "float32"}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_trees_bitwise(jtree, ttree):
    jl = {k: np.asarray(v) for k, v in _leaves(jtree).items()}
    tl = {k: v.detach().cpu().numpy() for k, v in _leaves(ttree).items()}
    assert sorted(jl) == sorted(tl)
    for k in jl:
        assert jl[k].dtype == tl[k].dtype and np.array_equal(jl[k], tl[k]), k


@pytest.fixture(scope="module")
def one_device():
    saved = jax_mesh._CURRENT_MESH
    jax_mesh.build_mesh(data=1, devices=jax.devices()[:1])
    yield
    jax_mesh._CURRENT_MESH = saved


def _model(kind, seed, **over):
    jcfg = {"bert": jbert, "distilbert": jdistil}[kind]("tiny", **over)
    jp = jax.tree.map(np.asarray, jtf.init_params(jcfg,
                                                  jax.random.PRNGKey(seed)))
    return jcfg, ttf.DecoderConfig(**jcfg.__dict__), jp, \
        params_from_jax(jp, device="cpu")


@pytest.fixture(scope="module")
def bert(one_device):
    return _model("bert", 2, max_seq_len=64)


def _padded(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, size=(2, 16), dtype=np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[0, 10:] = 0
    tokens[0, 10:] = 0
    types = np.zeros((2, 16), np.int32)
    types[:, 8:] = 1
    return tokens, mask, types


def test_init_params_tree_matches_jax_layout():
    """The port's init draws the JAX tree's leaves, the masked-LM head
    included (names, shapes, dtypes)."""
    jp = jtf.init_params(jbert("tiny"), jax.random.PRNGKey(0))
    tp = ttf.init_params(dt.bert_config("tiny"),
                         torch.Generator().manual_seed(0), device="cpu")
    jl, tl = _leaves(jax.tree.map(np.asarray, jp)), _leaves(tp)
    assert sorted(jl) == sorted(tl)
    for k in jl:
        assert tuple(jl[k].shape) == tuple(tl[k].shape), k


@pytest.mark.parametrize("kind", ["bert", "distilbert"])
def test_hf_round_trip_bitwise_both_ways(kind, tmp_path, one_device):
    """The JAX export loads into the port bitwise as the JAX loader loads
    it; the port's fp32 export is the JAX export byte for byte; the
    logits (segments B from position 8 for BERT) match the JAX forward."""
    jcfg, tcfg, jp, tp = _model(kind, 3)
    jhf.export_hf_checkpoint(jcfg, jp, str(tmp_path / "jax"))
    thf.export_hf_checkpoint(tcfg, tp, str(tmp_path / "port"))
    for f in ("model.safetensors", "config.json"):
        with open(tmp_path / "jax" / f, "rb") as a, \
                open(tmp_path / "port" / f, "rb") as b:
            assert a.read() == b.read(), f
    c1, want = jhf.load_hf_checkpoint(str(tmp_path / "port"))
    c2, got = thf.load_hf_checkpoint(str(tmp_path / "jax"), device="cpu")
    assert c2 == ttf.DecoderConfig(**c1.__dict__)
    _assert_trees_bitwise(want, got)
    tokens, _, types = _padded(tcfg, 0)
    kw = {} if kind == "distilbert" else {"token_type_ids": types}
    jl = jtf.forward(c1, jax.tree.map(jnp.asarray, want), jnp.asarray(tokens),
                     **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        tl = ttf.forward(c2, got, torch.from_numpy(tokens),
                         **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert _rel(tl.numpy(), jl) <= RTOL


def test_padded_batch_and_mask_matter(bert):
    """A right-padded batch with its attention_mask: logits within 1e-5
    of JAX's; without the mask the real positions of the padded row
    change (padding keys attend into every position)."""
    jcfg, tcfg, jp, tp = bert
    tokens, mask, types = _padded(tcfg, 7)
    want = jtf.forward(jcfg, jp, jnp.asarray(tokens),
                       token_type_ids=jnp.asarray(types),
                       attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = ttf.forward(tcfg, tp, torch.from_numpy(tokens),
                          token_type_ids=torch.from_numpy(types),
                          attention_mask=torch.from_numpy(mask)).numpy()
        no_mask = ttf.forward(tcfg, tp, torch.from_numpy(tokens),
                              token_type_ids=torch.from_numpy(types)).numpy()
    assert _rel(got, want) <= RTOL
    assert np.abs(no_mask[0, :10] - got[0, :10]).max() > 1e-4
    np.testing.assert_allclose(no_mask[1], got[1], rtol=1e-6, atol=1e-6)


def test_chunked_ce_with_mlm_head(bert):
    """The chunked CE decodes through the masked-LM transform and vocab
    bias: tiny chunks equal the dense loss, and both equal JAX's."""
    jcfg, tcfg, jp, tp = bert
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 32), dtype=np.int32)
    labels = rng.integers(0, jcfg.vocab_size, size=(2, 32), dtype=np.int32)
    jh, _ = jtf.forward_hidden(jcfg, jp, jnp.asarray(tokens))
    want = float(jtf.chunked_cross_entropy(jcfg, jp, jh,
                                           jnp.asarray(labels),
                                           chunk_size=4))
    with torch.no_grad():
        th, _ = ttf.forward_hidden(tcfg, tp, torch.from_numpy(tokens))
        lab = torch.from_numpy(labels)
        chunked = float(ttf.chunked_cross_entropy(tcfg, tp, th, lab,
                                                  chunk_size=4))
        dense = float(ttf.cross_entropy_loss(ttf.lm_logits(tcfg, tp, th),
                                             lab))
    np.testing.assert_allclose([chunked, dense], [want, want], rtol=RTOL)


def test_engine_matches_jax_engine_and_forward(bert):
    """Ragged lists through EncoderInference (padding to the longest,
    mask built here, outputs trimmed) against EncoderInferenceTPU and
    against one forward per sequence; hidden output too."""
    jcfg, tcfg, jp, tp = bert
    rng = np.random.default_rng(8)
    seqs = [rng.integers(1, jcfg.vocab_size, size=(n,)).tolist()
            for n in (7, 19, 12)]
    want = EncoderInferenceTPU(jcfg, ENG, params=jp)(seqs)
    eng = init_encoder_inference(tcfg, ENG, params=tp, device="cpu")
    got = eng(seqs)
    for s, g, w in zip(seqs, got, want):
        assert g.shape == (len(s), tcfg.vocab_size)
        assert _rel(g, w) <= RTOL
        with torch.no_grad():
            solo = ttf.forward(tcfg, eng.params,
                               torch.tensor([s], dtype=torch.int32))[0]
        assert _rel(g, solo.numpy()) <= RTOL
    hid = eng(seqs, output="hidden")
    assert hid[0].shape == (7, tcfg.hidden_size)


def test_quantized_engine_matches_jax(bert):
    jcfg, tcfg, jp, tp = bert
    seqs = [list(range(1, 13)), list(range(5, 14))]
    want = EncoderInferenceTPU(jcfg, dict(ENG, weight_quant="int8"),
                               params=jp)(seqs)
    eng = EncoderInference(tcfg, dict(ENG, weight_quant="int8"), params=tp,
                           device="cpu")
    assert eng.params["layers"]["attn"]["wq"].dtype == torch.int8
    for g, w in zip(eng(seqs), want):
        assert _rel(g, w) <= RTOL


def test_engine_rejects_decoder_and_tp(bert):
    """A decoder is refused; tensor parallelism runs (test_torch_tp_
    inference.py), but a mesh with a sequence axis does not."""
    from deepspeed_tpu_torch.parallel.mesh import Mesh
    _, _, _, tp = bert
    with pytest.raises(ValueError, match="bidirectional"):
        EncoderInference(dt.llama3_config("tiny"), device="cpu")
    with pytest.raises(NotImplementedError, match="Parallelism breadth"):
        EncoderInference(dt.bert_config("tiny"), params=tp, device="cpu",
                         mesh=Mesh({"seq": 2}))


def test_mlm_trains_like_jax_engine(bert):
    """MLM fine-tuning through initialize/train_batch with attention_mask,
    token_type_ids and labels -100 off the masked 15 %: 4 steps, losses
    within 1e-5 of the JAX engine's; 'auto' takes the chunked
    non-causal attention with the key mask in both."""
    jcfg, tcfg, jp, _ = bert
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, jcfg.vocab_size, size=(4, 32), dtype=np.int32)
    labels = np.full_like(tokens, -100)
    pick = rng.random((4, 32)) < 0.15
    labels[pick] = tokens[pick]
    masked = np.where(pick, 0, tokens).astype(np.int32)
    mask = np.ones((4, 32), np.int32)
    mask[1, 20:] = 0
    types = np.zeros((4, 32), np.int32)
    types[:, 16:] = 1
    batch = {"input_ids": masked, "labels": labels, "attention_mask": mask,
             "token_type_ids": types}
    conf = {"train_micro_batch_size_per_gpu": 4,
            "optimizer": {"type": "adamw", "params": {"lr": 5e-3}}}
    je, *_ = deepspeed_tpu.initialize(model=jcfg, config=dict(conf),
                                      params=jp)
    te, *_ = dt.initialize(model=tcfg, config=dict(conf), params=jp,
                           device="cpu")
    jl = [float(je.train_batch(iter([batch]))) for _ in range(4)]
    tl = [float(te.train_batch(iter([batch]))) for _ in range(4)]
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert tl[-1] < tl[0]

"""Import checkpoints saved by DeepSpeed into the port's parameter tree.

Port of ``deepspeed_tpu/checkpoint/ds_import.py``, over the port's
:func:`~deepspeed_tpu_torch.models.hf_loader.config_from_hf` and
:func:`~deepspeed_tpu_torch.models.hf_loader.params_from_state`. The
formats, all ``.pt`` files read with ``torch.load``:

1. **Engine checkpoints** — ``<dir>/<tag>/mp_rank_00_model_states.pt``
   written by ``engine.save_checkpoint``. The ``module`` entry is the
   wrapped model's own ``state_dict()``; for HF models that means HF
   tensor names, so the mapping into the tree is the HF-interop mapping.
   The optional ``latest`` file at the directory root names the tag.
2. **Universal checkpoints** — ``<dir>/<tag>/zero/<param_name>/fp32.pt``
   per-parameter fp32 fragments produced by ``ds_to_universal.py``.
3. **MoE expert shards** — ``layer_<L>_expert_<E>_mp_rank_00_model_states.pt``
   (and the legacy ``expert_<E>_mp_rank_*`` form). Expert keys carry the
   DeepSpeed-MoE wrapper infix ``.deepspeed_moe.experts.deepspeed_experts.
   <gid>.``; stripping it back to ``.experts.<gid>.`` recovers the wrapped
   module's own naming.
4. **ZeRO optimizer shards** —
   ``(bf16_)zero_pp_rank_<d>_mp_rank_00_optim_states.pt``: the fp32 master
   partitions are the weights of a ZeRO run, reconstructed as DeepSpeed's
   offline ``utils/zero_to_fp32.py`` does (Z1/2: per-group concat across
   dp ranks; Z3: per-param zip of per-rank slices). Adam moments ride the
   same flat layout and are reconstructed alongside when asked for.

Model-parallel (``mp_rank_01+``) shards are refused with instructions to
consolidate first. Every state tensor is read as fp32 (as the reference
reads it), then cast to ``dtype`` and moved to ``device`` by the loader.
"""

import glob
import os
import re
from typing import Any, Dict, Optional, Tuple, Union

import torch

from deepspeed_tpu_torch.checkpoint.store import latest_tag
from deepspeed_tpu_torch.models.hf_loader import (config_from_hf,
                                                  params_from_state)
from deepspeed_tpu_torch.models.transformer import DecoderConfig
from deepspeed_tpu_torch.utils.logging import logger

Params = Any
Device = Optional[Union[str, torch.device]]


def resolve_tag(ckpt_dir: str, tag: Optional[str] = None) -> str:
    """Tag resolution following DeepSpeed's ``latest`` convention."""
    if tag is not None:
        return tag
    latest = latest_tag(ckpt_dir)
    if latest is not None:
        return latest
    # single-subdir checkpoint dirs are unambiguous
    subs = [d for d in sorted(os.listdir(ckpt_dir))
            if os.path.isdir(os.path.join(ckpt_dir, d))]
    if len(subs) == 1:
        return subs[0]
    raise ValueError(
        f"cannot resolve checkpoint tag in {ckpt_dir}: no 'latest' file "
        f"and {len(subs)} candidate subdirectories {subs}")


def _strip_prefixes(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Strip wrapper prefixes ('module.', DDP-style) off state-dict keys."""
    for prefix in ("module.", "model.module."):
        if all(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()}
    return sd


def _fp32(t: Any) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu").float()
    return torch.as_tensor(t, dtype=torch.float32)


def _state_reader(sd: Dict[str, Any]):
    """(get, names) view over a torch state dict."""
    def get(name: str) -> torch.Tensor:
        return _fp32(sd[name])
    return get, set(sd.keys())


def _load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=False)


def load_ds_checkpoint(ckpt_dir: str, hf_config: Dict[str, Any],
                       tag: Optional[str] = None,
                       dtype: torch.dtype = torch.float32,
                       device: Device = None
                       ) -> Tuple[DecoderConfig, Params]:
    """Load a DeepSpeed engine checkpoint into ``(DecoderConfig, params)``
    on ``device`` (None → CUDA).

    ``hf_config`` is the HF ``config.json`` dict of the wrapped model
    (DeepSpeed does not checkpoint the model config)."""
    tag = resolve_tag(ckpt_dir, tag)
    path = os.path.join(ckpt_dir, tag, "mp_rank_00_model_states.pt")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no model states at {path}")
    other = os.path.join(ckpt_dir, tag, "mp_rank_01_model_states.pt")
    if os.path.exists(other):
        raise ValueError(
            f"{ckpt_dir} is a model-parallel checkpoint ({other} "
            "exists). Consolidate it first (DeepSpeed's "
            "ds_to_universal.py merges TP slices), then import the "
            "universal checkpoint via load_universal_checkpoint().")
    blob = _load(path)
    sd = blob.get("module", blob)
    if not isinstance(sd, dict):
        raise ValueError(f"unexpected model-states payload in {path}")
    # MoE runs save expert weights in separate per-expert shard files;
    # fold them back in before mapping
    merge_expert_shards(ckpt_dir, tag, sd)
    sd = _strip_prefixes(sd)
    # ZeRO-3 model states saved without gather_16bit_weights hold 0-size
    # placeholders (params live in the zero_pp_rank_* optimizer shards)
    if any(getattr(t, "numel", lambda: 1)() == 0 for t in sd.values()):
        raise ValueError(
            f"{path} holds ZeRO-3 placeholder (0-size) tensors — the "
            "weights live in the zero_pp_rank_* shards. Re-save with "
            "stage3_gather_16bit_weights_on_model_save, or convert with "
            "DeepSpeed's ds_to_universal.py / zero_to_fp32.py and "
            "import via load_universal_checkpoint().")
    cfg = config_from_hf(hf_config)
    get, names = _state_reader(sd)
    params = params_from_state(cfg, hf_config, get, names, dtype, device)
    logger.info(f"imported DeepSpeed checkpoint {ckpt_dir}@{tag}: "
                f"{cfg.num_params() / 1e6:.1f}M params")
    return cfg, params


_MOE_INFIX = ".deepspeed_moe.experts.deepspeed_experts."


def _natural_key(path: str):
    return [int(t) if t.isdigit() else t
            for t in re.split(r"(\d+)", os.path.basename(path))]


def merge_expert_shards(ckpt_dir: str, tag: str,
                        sd: Dict[str, Any]) -> int:
    """Fold DeepSpeed's per-expert shard files into ``sd``, the
    DeepSpeed-MoE wrapper infix stripped so keys return to the wrapped
    module's own naming: ``<p>.deepspeed_moe.experts.deepspeed_experts.
    <gid>.<w>`` → ``<p>.experts.<gid>.<w>``. Returns the number of expert
    files merged."""
    root = os.path.join(ckpt_dir, tag)
    files = sorted(
        glob.glob(os.path.join(root, "layer_*_expert_*_model_states.pt"))
        + glob.glob(os.path.join(root, "expert_*_model_states.pt")),
        key=_natural_key)
    for path in files:
        if "_mp_rank_00_" not in os.path.basename(path) and \
                "_mp_rank_" in os.path.basename(path):
            raise ValueError(
                f"{path} is a model-parallel expert shard; consolidate TP "
                f"first (same restriction as mp_rank_01 model states)")
        esd = _load(path)
        esd = esd.get("model", esd)
        for key, val in esd.items():
            if _MOE_INFIX in key:
                prefix, rest = key.split(_MOE_INFIX, 1)
                key = f"{prefix}.experts.{rest}"
            sd[key] = val
    if files:
        logger.info(f"merged {len(files)} DeepSpeed MoE expert shards")
    return len(files)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _reconstruct_flat_z2(shapes_groups, per_rank_groups
                         ) -> Dict[str, torch.Tensor]:
    """Z1/2: per-group partitions concatenated across dp ranks, then
    sliced by param shape in declaration order (trailing alignment
    padding is left unread)."""
    out: Dict[str, torch.Tensor] = {}
    for gi, shapes in enumerate(shapes_groups):
        merged = torch.cat([_fp32(rank[gi]).reshape(-1)
                            for rank in per_rank_groups])
        off = 0
        for name, shape in shapes.items():
            shape = tuple(shape)
            n = _numel(shape)
            out[name] = merged[off:off + n].reshape(shape)
            off += n
    return out


def _reconstruct_flat_z3(shapes_groups, per_rank_flats, world_size
                         ) -> Dict[str, torch.Tensor]:
    """Z3: every param is partitioned per-param (padded to world_size);
    rank r holds [offset, offset+ceil(n/ws)) of each param — zip the
    per-rank slices back."""
    shapes = {k: v for d in shapes_groups for k, v in d.items()}
    ranks = [torch.cat([_fp32(t).reshape(-1) for t in flats])
             for flats in per_rank_flats]
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape in shapes.items():
        shape = tuple(shape)
        n = _numel(shape)
        pn = -(-n // world_size)
        full = torch.cat([r[off:off + pn] for r in ranks])
        out[name] = full[:n].reshape(shape)
        off += pn
    return out


def load_zero_checkpoint(ckpt_dir: str, hf_config: Dict[str, Any],
                         tag: Optional[str] = None,
                         dtype: torch.dtype = torch.float32,
                         load_optimizer_states: bool = False,
                         device: Device = None):
    """Import a DeepSpeed ZeRO checkpoint directly from its
    ``zero_pp_rank_*_optim_states.pt`` shards — no ds_to_universal pass.

    With ``load_optimizer_states`` (stage ≤ 2), the Adam moments — which
    ride the identical flat layout — are reconstructed too and mapped
    through the same HF-interop transform as the weights, in fp32.

    Returns ``(cfg, params)`` or ``(cfg, params, moments)`` where moments
    is ``{"exp_avg": tree, "exp_avg_sq": tree, "step": int}``.
    """
    tag = resolve_tag(ckpt_dir, tag)
    root = os.path.join(ckpt_dir, tag)
    files = sorted(glob.glob(os.path.join(root, "*_optim_states.pt")),
                   key=_natural_key)
    if not files:
        raise FileNotFoundError(f"no *_optim_states.pt under {root}")
    osds = [_load(f)["optimizer_state_dict"] for f in files]
    stage = int(osds[0]["zero_stage"])
    world = osds[0]["partition_count"]
    if isinstance(world, (list, tuple)):
        world = max(world)
    world = int(world)
    if world != len(files):
        raise ValueError(
            f"expected {world} optim shards under {root}, found "
            f"{len(files)} — incomplete checkpoint")

    # param_shapes live in the model-states file
    ms_name = "zero_pp_rank_0_mp_rank_00_model_states.pt" if stage == 3 \
        else "mp_rank_00_model_states.pt"
    ms_path = os.path.join(root, ms_name)
    if not os.path.exists(ms_path):
        raise FileNotFoundError(f"no model states at {ms_path}")
    shapes_groups = _load(ms_path)["param_shapes"]
    if isinstance(shapes_groups, dict):
        shapes_groups = [shapes_groups]

    if stage <= 2:
        per_rank = [osd["single_partition_of_fp32_groups"] for osd in osds]
        fp32 = _reconstruct_flat_z2(shapes_groups, per_rank)
    else:
        per_rank = [osd["fp32_flat_groups"] for osd in osds]
        fp32 = _reconstruct_flat_z3(shapes_groups, per_rank, world)

    names = set(fp32.keys())
    strip = names and all(n.startswith("module.") for n in names)

    def reader(table):
        def get(name):
            return table["module." + name if strip else name]
        return get

    cfg = config_from_hf(hf_config)
    vis_names = {n[len("module."):] for n in names} if strip else names
    params = params_from_state(cfg, hf_config, reader(fp32), vis_names,
                               dtype, device)
    logger.info(f"imported DeepSpeed ZeRO-{stage} checkpoint "
                f"{ckpt_dir}@{tag}: dp={world}, "
                f"{cfg.num_params() / 1e6:.1f}M params (direct from "
                f"optim shards, no ds_to_universal)")
    if not load_optimizer_states:
        return cfg, params

    if stage == 3:
        raise ValueError(
            "load_optimizer_states for DeepSpeed stage-3 checkpoints is "
            "not supported (sub-group moment layout); load weights only "
            "and let the engine rebuild moments")

    def _group_states(osd):
        """Per-group inner Adam state: 'base_optimizer_state' holds
        either the torch optimizer state_dict (non-elastic) or a
        per-group list (elastic); 'optimizer_state_dict' is accepted as a
        fallback variant."""
        base = osd.get("base_optimizer_state")
        if base is None:
            base = osd.get("optimizer_state_dict") or {}
        if isinstance(base, list):
            return base
        state = base.get("state", {})
        return [state[i] for i in sorted(state)]

    moments: Dict[str, Any] = {}
    for key in ("exp_avg", "exp_avg_sq"):
        per_rank_m = []
        for osd in osds:
            gs = _group_states(osd)
            if len(gs) < len(shapes_groups):
                raise ValueError(
                    f"optimizer shard holds {len(gs)} group states, "
                    f"expected {len(shapes_groups)}")
            per_rank_m.append([gs[i][key]
                               for i in range(len(shapes_groups))])
        table = _reconstruct_flat_z2(shapes_groups, per_rank_m)
        moments[key] = params_from_state(cfg, hf_config, reader(table),
                                         vis_names, torch.float32, device)
    step = osds[0].get("base_optimizer_state_step")
    if step is None:
        gs = _group_states(osds[0])
        step = gs[0].get("step", 0) if gs else 0
    moments["step"] = int(step.item() if hasattr(step, "item") else step)
    return cfg, params, moments


def load_universal_checkpoint(ckpt_dir: str, hf_config: Dict[str, Any],
                              tag: Optional[str] = None,
                              dtype: torch.dtype = torch.float32,
                              device: Device = None
                              ) -> Tuple[DecoderConfig, Params]:
    """Load a DeepSpeed *universal* checkpoint (ds_to_universal output).

    Layout: ``<dir>/<tag>/zero/<param_name>/fp32.pt`` holds the merged
    full-shape fp32 weight per parameter. Optimizer-state fragments
    (``exp_avg.pt`` …) are ignored.
    """
    tag = resolve_tag(ckpt_dir, tag)
    zero_dir = os.path.join(ckpt_dir, tag, "zero")
    if not os.path.isdir(zero_dir):
        raise FileNotFoundError(f"no universal-checkpoint dir at {zero_dir}")

    def get(name: str) -> torch.Tensor:
        # no caching: each param is read exactly once by params_from_state
        t = _load(os.path.join(zero_dir, name, "fp32.pt"))
        if isinstance(t, dict):                      # {'param': tensor} form
            t = t.get("param", t)
        return _fp32(t)

    names = {d for d in os.listdir(zero_dir)
             if os.path.exists(os.path.join(zero_dir, d, "fp32.pt"))}
    # param dirs may carry the 'module.' prefix; normalize both views
    if names and all(n.startswith("module.") for n in names):
        raw_get = get

        def get(name):                               # noqa: F811
            return raw_get("module." + name)
        names = {n[len("module."):] for n in names}
    cfg = config_from_hf(hf_config)
    params = params_from_state(cfg, hf_config, get, names, dtype, device)
    logger.info(f"imported universal checkpoint {ckpt_dir}@{tag}: "
                f"{cfg.num_params() / 1e6:.1f}M params")
    return cfg, params

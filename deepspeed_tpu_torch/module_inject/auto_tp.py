"""AutoTP — tensor-parallel specs for arbitrary parameter trees.

Port of ``deepspeed_tpu/module_inject/auto_tp.py`` (:24-141; reference
``module_inject/auto_tp.py:193``, ``tp_parser`` :285, ``_replace``
:348). The planner classifies each leaf by its path, with the same name
patterns, and returns a spec tree — each leaf a tuple with one entry per
dim, None or an axis name — in the form of
:func:`deepspeed_tpu_torch.models.transformer.partition_specs`:

- **column-parallel** (the OUTPUT dim over 'model'): q/k/v/qkv
  projections, MLP up/gate projections;
- **row-parallel** (the INPUT dim; the product is all-reduced after):
  attention output and MLP down projections;
- **vocab-parallel**: embedding and lm_head tables;
- everything else replicates (norms, biases of row-parallel layers).

A dim that does not divide by ``tp_size`` replicates, with a warning.
"""

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import log_dist, logger

Pytree = Any

#: reference auto_tp.py tp_parser name heuristics (lowercased substrings)
_COL_PATTERNS = ("q_proj", "k_proj", "v_proj", "qkv", "wq", "wk", "wv",
                 "gate_proj", "up_proj", "wi", "wg", "w1", "w3",
                 "fc1", "fc_in", "dense_h_to_4h", "query", "key", "value")
_ROW_PATTERNS = ("o_proj", "out_proj", "wo", "down_proj", "w2", "fc2",
                 "fc_out", "dense_4h_to_h", "attention/dense", "proj_out")
_VOCAB_PATTERNS = ("embed", "wte", "lm_head", "word_embeddings")
_SKIP_PATTERNS = ("norm", "ln", "bias", "rotary", "scale")


@dataclass
class TPRule:
    """One classification outcome for a leaf."""
    kind: str          #: 'column' | 'row' | 'vocab' | 'replicate'
    dim: Optional[int] = None   #: which dim gets the 'model' axis


def _is_float(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    return np.issubdtype(np.asarray(leaf).dtype, np.floating)


def _items(tree, prefix=()):
    """(path, leaf) pairs; dict keys in sorted order, as JAX flattens."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _rebuild(tree, values, prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return values["/".join(prefix)]


class AutoTPPlanner:
    """tp_parser + _replace as a spec planner (reference AutoTP)."""

    def __init__(self, tp_axis: str = "model",
                 extra_column: Sequence[str] = (),
                 extra_row: Sequence[str] = ()):
        self.tp_axis = tp_axis
        self.col = tuple(p.lower() for p in _COL_PATTERNS) + \
            tuple(p.lower() for p in extra_column)
        self.row = tuple(p.lower() for p in _ROW_PATTERNS) + \
            tuple(p.lower() for p in extra_row)

    # -- classification (reference tp_parser:285) --------------------------

    def classify(self, path: str, leaf) -> TPRule:
        name = path.lower()
        nd = len(np.shape(leaf))
        if nd < 2 or not _is_float(leaf):
            return TPRule("replicate")
        if any(p in name for p in _SKIP_PATTERNS) and \
                not any(p in name for p in self.col + self.row):
            return TPRule("replicate")
        if any(p in name for p in self.row):
            # row-parallel: shard the INPUT (second-to-last) dim
            return TPRule("row", dim=nd - 2)
        if any(p in name for p in self.col):
            # column-parallel: shard the OUTPUT (last) dim
            return TPRule("column", dim=nd - 1)
        if any(p in name for p in _VOCAB_PATTERNS):
            # vocab dim = the bigger of the trailing two dims
            shape = np.shape(leaf)
            return TPRule("vocab",
                          dim=nd - 2 if shape[nd - 2] >= shape[nd - 1]
                          else nd - 1)
        return TPRule("replicate")

    # -- spec construction (reference _replace:348) ------------------------

    def build_specs(self, params: Pytree, tp_size: int = 1,
                    fsdp_axes: Optional[Tuple[str, ...]] = None
                    ) -> Pytree:
        """The spec tree of ``params``. Leaves whose sharded dim does not
        divide by ``tp_size`` replicate, with a warning."""
        specs = {}
        counts = {"column": 0, "row": 0, "vocab": 0, "replicate": 0}
        for key, leaf in _items(params):
            rule = self.classify(key, leaf)
            nd = len(np.shape(leaf))
            entries: List[Any] = [None] * nd
            if rule.dim is not None and tp_size > 1:
                if np.shape(leaf)[rule.dim] % tp_size:
                    logger.warning(
                        f"AutoTP: '{key}' dim {rule.dim} size "
                        f"{np.shape(leaf)[rule.dim]} not divisible by "
                        f"tp={tp_size}; replicating")
                    rule = TPRule("replicate")
                else:
                    entries[rule.dim] = self.tp_axis
            if fsdp_axes and nd >= 2:
                # FSDP on a dim the TP axis didn't take
                for d in range(nd):
                    if entries[d] is None:
                        entries[d] = fsdp_axes
                        break
            counts[rule.kind] += 1
            specs[key] = tuple(entries) if any(
                e is not None for e in entries) else ()
        log_dist(f"AutoTP plan: {counts['column']} column, "
                 f"{counts['row']} row, {counts['vocab']} vocab, "
                 f"{counts['replicate']} replicated")
        return _rebuild(params, specs)


def autotp_specs(params: Pytree, tp_size: int,
                 fsdp_axes: Optional[Tuple[str, ...]] = None,
                 **kw) -> Pytree:
    """One-call AutoTP (reference module_inject.replace_module entry)."""
    return AutoTPPlanner(**kw).build_specs(params, tp_size,
                                           fsdp_axes=fsdp_axes)

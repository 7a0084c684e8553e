"""The training pieces the whisper trainers share with the JAX package's
``train/trainer.py``: the masked next-token loss and the restore of a
train state from a checkpoint. The YOHO ``ASRTrainer`` comes with the
YOHO train stages (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from yoho_tpu_torch.train.checkpoint import load_checkpoint
from yoho_tpu_torch.train.optim import load_state


def masked_ce_loss(logits: torch.Tensor, tokens: torch.Tensor,
                   loss_mask: torch.Tensor) -> torch.Tensor:
    """Next-token CE, masked: position i's logits predict token i + 1, the
    mask of token i + 1 weighs it, and the sum is divided by
    ``max(sum(mask), 1)``; float32."""
    logits = logits[:, :-1].float()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         tokens[:, 1:].reshape(-1).long(), reduction="none")
    mask = loss_mask[:, 1:].reshape(-1).float()
    return torch.sum(ce * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    """Nested dicts -> '/'-joined paths."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, path))
        else:
            out[path] = v
    return out


def unflatten_tree(flat: Mapping[str, object]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


@torch.no_grad()
def restore_train_state(leaves: Dict[str, torch.Tensor], opt_state: dict,
                        checkpoint_path, nest=unflatten_tree) -> Optional[int]:
    """Restore a checkpoint into the live train state: ``leaves`` (the
    checkpointed tensors by '/'-joined JAX path, in the JAX layout, updated
    in place; ``nest`` builds the saved tree from such a dict) and
    ``opt_state`` (the optimizer's state, updated in place, each tensor on
    its own device). Returns the checkpoint's step (mini-steps), or None
    when there is no checkpoint (nothing changes)."""
    template = nest({k: np.empty(tuple(t.shape), np.float32) for k, t in leaves.items()})
    restored = load_checkpoint(checkpoint_path, template)
    if restored is None:
        return None
    step, params, saved_opt = restored
    for k, v in flatten_tree(params).items():
        src = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        leaves[k].copy_(src)
    load_state(opt_state, saved_opt)
    return step

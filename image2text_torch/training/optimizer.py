"""Optimizers: SNRAdam and pattern-driven parameter groups (counterpart
of ``image2text_tpu/training/optimizer.py``).

* :class:`SNRAdam` is the JAX package's ``snr_adam`` as a
  ``torch.optim.Optimizer``: the ``iter == 1`` branch, the variance of
  ``g − m̂`` taken with the *pre-update* bias-corrected first moment, the
  *post-update* bias-corrected first moment in the numerator, decoupled
  ``lr·wd·p`` weight decay, one ``iter`` counter per group.
* :func:`build_optimizer` assigns every parameter to the first
  ``OptimizerConfig`` whose ``target_modules`` patterns match its path
  with the leading component stripped; the EMA teacher (``model_m.*``),
  the module's frozen paths (``nn.core.frozen_param_paths``) and
  unmatched parameters get no update (JAX's ``set_to_zero``) and stop
  requiring gradients.  SNRAdam groups
  when ``use_snr``, else AdamW groups (``optax.adamw``'s rule: eps 1e-8,
  decoupled weight decay).

The training step gives a parameter that received no gradient a zero
one, as the JAX package's dense gradient tree has.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from image2text_torch.configs.trainer import OptimizerConfig
from image2text_torch.nn.core import frozen_param_paths
from image2text_torch.utils.checkpoint import split_specs
from image2text_torch.utils.patterns import PatternMatcher


class SNRAdam(torch.optim.Optimizer):
    def __init__(self, params, lr: float, betas: Tuple[float, float] = (
            0.9, 0.999), weight_decay: float = 0.0, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=tuple(betas),
                                      weight_decay=weight_decay, eps=eps,
                                      iter=1))

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every group, each formula applied to all of the
        group's tensors at once (``torch._foreach_*``: a few launches per
        group, not a dozen per parameter)."""
        for group in self.param_groups:
            it, (b1, b2) = group["iter"], group["betas"]
            lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
            ps = group["params"]
            for p in ps:
                if not self.state[p]:
                    self.state[p]["exp_avg"] = torch.zeros_like(
                        p, dtype=torch.float32)
                    self.state[p]["exp_avg_sq"] = torch.zeros_like(
                        p, dtype=torch.float32)
            gs = [p.grad.float() for p in ps]
            ms = [self.state[p]["exp_avg"] for p in ps]
            vs = [self.state[p]["exp_avg_sq"] for p in ps]
            # d = g − m̂ with the pre-update first moment (g at iter 1)
            d = gs if it == 1 else torch._foreach_sub(
                gs, torch._foreach_div(ms, 1.0 - b1 ** (it - 1)))
            dd = torch._foreach_mul(d, 1.0 - b2)
            torch._foreach_mul_(dd, d)
            torch._foreach_mul_(vs, b2)
            torch._foreach_add_(vs, dd)
            del d, dd
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, torch._foreach_mul(gs, 1.0 - b1))
            s = torch._foreach_div(ms, 1.0 - b1 ** it)
            torch._foreach_mul_(s, -lr)
            den = torch._foreach_div(vs, 1.0 - b2 ** it)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            torch._foreach_div_(s, den)
            del den
            if wd != 0.0:
                torch._foreach_sub_(s, torch._foreach_mul(
                    [p.float() for p in ps], lr * wd))
            torch._foreach_add_(ps, [x.to(p.dtype) for x, p in zip(s, ps)])
            group["iter"] = it + 1


def _strip_head(path: str) -> str:
    """Patterns match names with the wrapper prefix removed."""
    return path.split(".", 1)[-1] if "." in path else path


def assign_param_labels(param_paths: Sequence[str],
                        optim_configs: Sequence[OptimizerConfig],
                        frozen_paths: Sequence[str] = (),
                        split_specs=None) -> Dict[str, str]:
    """{path: 'group_i' | 'frozen'}: the first matching group wins; the
    teacher and frozen paths are 'frozen'.  ``split_specs`` ({path:
    (key template, count)}) lets stacked experts match patterns written
    for their per-expert names."""
    frozen = set(frozen_paths)
    split_specs = split_specs or {}
    matchers = []
    for oc in optim_configs:
        if oc.target_modules is None and len(optim_configs) != 1:
            raise ValueError("a catch-all optimizer group must be the only "
                             "group")
        matchers.append(None if oc.target_modules is None
                        else PatternMatcher(oc.target_modules))
    labels: Dict[str, str] = {}
    for path in param_paths:
        labels[path] = "frozen"
        if path.startswith("model_m.") or path in frozen:
            continue
        if path in split_specs:
            template, count = split_specs[path]
            candidates = [template.format(i=i) for i in range(count)]
        else:
            candidates = [path]
        for i, m in enumerate(matchers):
            if m is None or any(m.match(_strip_head(c)) for c in candidates):
                labels[path] = f"group_{i}"
                break
    return labels


def build_optimizer(module: torch.nn.Module,
                    optim_configs: Sequence[OptimizerConfig],
                    use_snr: bool = False, extra_frozen: Sequence[str] = ()):
    """(optimizer, {path: label}) over ``module``'s parameters; one
    parameter group per OptimizerConfig that matched anything."""
    params = dict(module.named_parameters())
    specs = {path: (template, params[path].shape[0])
             for path, template in split_specs(module).items()}
    frozen = frozen_param_paths(module) + list(extra_frozen)
    labels = assign_param_labels(list(params), optim_configs, frozen, specs)
    for path, label in labels.items():
        # no optimizer moves it, so no backward computes its gradient (the
        # JAX step computes one and drops it); this is what keeps the
        # frozen weights of the large decoders free of gradient memory
        if label == "frozen":
            params[path].requires_grad_(False)
    groups: List[dict] = []
    for i, oc in enumerate(optim_configs):
        members = [params[p] for p, lab in labels.items()
                   if lab == f"group_{i}"]
        if members:
            groups.append(dict(params=members, lr=oc.lr,
                               betas=tuple(oc.betas),
                               weight_decay=oc.weight_decay))
    if use_snr:
        opt = SNRAdam(groups, lr=optim_configs[0].lr)
    else:
        opt = torch.optim.AdamW(groups, lr=optim_configs[0].lr, eps=1e-8)
    return opt, labels

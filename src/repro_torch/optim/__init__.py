"""Optimizer dispatch: ocfg.name ∈ {'adamw', 'adafactor'} (answers
`src/repro/optim/__init__.py`). Both update the parameters and their
state in place and return them."""
from repro_torch.configs.base import OptimConfig
from repro_torch.optim import adafactor, adamw


def _mod(ocfg: OptimConfig):
    return adafactor if ocfg.name == "adafactor" else adamw


def init_opt_state(params, ocfg: OptimConfig):
    return _mod(ocfg).init_opt_state(params, ocfg)


def opt_state_axes(param_axes, ocfg: OptimConfig, params=None):
    """``params``: the parameter tree, which Adafactor's stacked state
    needs (its `LayerStack` periods)."""
    return _mod(ocfg).opt_state_axes(param_axes, ocfg, params)


def apply_updates(params, grads, opt_state, ocfg: OptimConfig, lr,
                  grad_scale: float = 1.0):
    return _mod(ocfg).apply_updates(params, grads, opt_state, ocfg, lr,
                                    grad_scale=grad_scale)

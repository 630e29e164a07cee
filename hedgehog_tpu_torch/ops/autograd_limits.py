"""How far autograd reaches through the CUDA kernels, stated where it meets them.

The kernels with a backward (K11 behind K7's values, K12 behind the QE
surface, K17/K18 behind the rough-Bergomi values) have no forward mode and
no double backward, as the JAX package's ``custom_vjp`` rules have none:
their ``torch.autograd.Function``\\ s call :func:`refuse_forward_mode` from
``jvp`` and return their gradients through :func:`first_order_only`.  The
kernels that read their inputs as host floats and have no backward (K1, K2,
K5, K13, the one-step rough-Bergomi values) return through
:func:`no_derivative`.  Either way a derivative that would leave the
kernel's part out raises instead.  The Functions define ``setup_context``,
so ``torch.func`` reaches these refusals as ``torch.autograd`` does.
"""

from __future__ import annotations

import torch

__all__ = [
    "FIRST_ORDER",
    "ForwardState",
    "first_order_only",
    "host_float_kernel",
    "no_derivative",
    "refuse_forward_mode",
]

FIRST_ORDER = "take first-order greeks with ReverseAD, or price with use_kernel=False"


class ForwardState:
    """What a Function's ``forward`` leaves for its ``setup_context`` (the
    device inputs it built, the host floats it read): a plain object, which
    ``torch.func`` passes through its input trees untouched, where a dict
    would be rebuilt."""

    state: tuple = ()


def refuse_forward_mode(kernel: str):
    raise TypeError(f"{kernel} has a backward only, no forward mode: {FIRST_ORDER}")


class _NoDerivative(torch.autograd.Function):
    """The values unchanged; a derivative through them raises ``error``, an
    (exception type, message) pair."""

    @staticmethod
    def forward(values, error, *consumed):
        return values

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.error = inputs[1]

    @staticmethod
    def backward(ctx, ct):
        raise ctx.error[0](ctx.error[1])

    @staticmethod
    def jvp(ctx, *tangents):
        raise ctx.error[0](ctx.error[1])


def _guard(values, error, consumed):
    tensors = [x for x in consumed if isinstance(x, torch.Tensor)]
    return _NoDerivative.apply(values, error, *tensors) if tensors else values


def first_order_only(grads, kernel: str, *consumed) -> tuple:
    """The gradients a kernel's backward returns, from ``consumed`` (the
    Function's inputs and the cotangent).  Under ``create_graph=True`` (and
    ``torch.func``'s transforms, which build one) a derivative of them, a
    second derivative through the kernel, raises TypeError: to autograd the
    kernel's sums are constants, so it would be silently incomplete."""
    if not torch.is_grad_enabled():
        return grads
    error = (TypeError, f"{kernel} has no second derivative (its backward is a kernel): "
                        f"{FIRST_ORDER}")
    return tuple(None if g is None else _guard(g, error, consumed) for g in grads)


def host_float_kernel(kernel: str) -> str:
    """The reason :func:`no_derivative` gives for a kernel without a backward."""
    return (f"{kernel} reads its inputs as host floats and has no derivative: "
            "price with use_kernel=False")


def no_derivative(values: torch.Tensor, reason: str, *consumed) -> torch.Tensor:
    """``values`` computed by a kernel from ``consumed`` (numbers or tensors)
    read as host floats: a derivative of them in a consumed tensor raises
    NotImplementedError(``reason``), in reverse and in forward mode."""
    return _guard(values, (NotImplementedError, reason), consumed)

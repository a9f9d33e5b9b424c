"""Stand-ins for the port's CUDA kernels on the CPU, at the seams of
``repro_torch/kernels/native.py`` that every wrapper goes through.

``install(monkeypatch, **kernels)``: CPU tensors take the card's route
(``native.route`` answers ``CUDA`` for ``CPU`` and ``SHARDED_CUDA`` for
``SHARDED_CPU``), the card has ``SMS`` SMs (``native.sm_count``), and each
launch (``native.Library.call``) goes to ``kernels[name]``, the library's
name, with the launch's arguments as the wrapper passes them (tensors as
tensors, then the ints; the stream is not passed):

- ``flash_attention``: q, k, v, out, B, S, H, K, hd, causal, window;
- ``flash_mla``: q, k, v, out, B, S, H, K, dk, dv, causal, scale * log2(e);
- ``ssd_scan``: xh, dt, A, Bmat, Cmat, initial_state, y, final, the four
  scratch buffers, B, S, nh, hd, N, Q;
- ``decode_attention``: q, cache_k, cache_v, out, part_acc, part_ml, the
  position's tensor (or None), the int position, B, W, H, K, hd, splits,
  chunk;
- ``mamba_step``: xr, bc, dt, state, conv_x, conv_bc, w_x, b_x, w_bc,
  b_bc, dt_bias, A_log, D, y, the B‖C scratch, B, nh, hd, N, d_conv
  (``mamba_step`` below writes the plain step into the kernel's outputs);
- ``iou_matrix``: the addresses of a, b and the three offsets, out, the
  batch, the total and the outputs per thread.

``reroute(monkeypatch, table)`` changes only the route (``OFF_CARD``: the
card's tensors take the CPU's route); ``library(monkeypatch, cdll, *libs)``
stands ``cdll`` in for the built library of each of ``libs``, the launch
itself kept (on the CPU: the card's device and stream left out).
"""
import contextlib
import types

import torch

from repro_torch.kernels import native
from repro_torch.kernels.mamba_step.ref import conv_step, mamba_step_torch

ON_CARD = {native.CPU: native.CUDA, native.SHARDED_CPU: native.SHARDED_CUDA}
OFF_CARD = {v: k for k, v in ON_CARD.items()}
SMS = 132

_route = native.route


def reroute(monkeypatch, table=ON_CARD) -> None:
    """``native.route``'s answers mapped through ``table`` (``{}``: the
    route itself)."""
    def route(*tensors):
        case = _route(*tensors)
        return table.get(case, case)
    monkeypatch.setattr(native, "route", route)


def install(monkeypatch, sms: int = SMS, **kernels) -> None:
    """CPU tensors on a card of ``sms`` SMs whose launches are
    ``kernels`` (see the module docstring); a launch of a library not
    given raises."""
    def call(lib, device, *args):
        kernels[lib.name](*args)
    reroute(monkeypatch)
    monkeypatch.setattr(native.Library, "call", call)
    monkeypatch.setattr(native, "sm_count", lambda device: sms)


def noop(*args) -> None:
    """A launch that does nothing."""


def mamba_step(xr, bc, dt, state, conv_x, conv_bc, w_x, b_x, w_bc, b_bc,
               dt_bias, A_log, D, y, bc_out, B, nh, hd, N, d_conv) -> None:
    """The Mamba step kernel on the CPU: the plain step's outputs written
    into the kernel's, B‖C's conv step into the scratch, y filled, the
    state and both windows in place (by index, never by a ``copy_``)."""
    bc_out[...] = conv_step(conv_bc, bc, w_bc, b_bc)[0]
    y[...], (state[...], (conv_x[...], conv_bc[...])) = mamba_step_torch(
        xr, bc, dt, state, conv_x, conv_bc, w_x, b_x, w_bc, b_bc, dt_bias,
        A_log, D)


def library(monkeypatch, cdll, *libs) -> None:
    """``cdll`` loaded in place of each of ``libs`` (``native.Library``)
    at its next use; the current device and stream are the CPU's no-ops."""
    monkeypatch.setattr(native.build, "load", lambda source: cdll)
    for lib in libs:
        monkeypatch.setattr(lib, "_lib", None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))

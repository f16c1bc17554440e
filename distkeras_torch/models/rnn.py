"""Recurrent models (LSTM / GRU): the reference's Keras-RNN family.

Counterpart of ``distkeras_tpu/models/rnn.py``, registered under ``"rnn"``
with the same config.  The submodules carry Flax's names, so the weight
bridge and the model blob share one key map: ``Embed_0`` (token inputs), one
cell a layer (``OptimizedLSTMCell_i`` or ``GRUCell_i``, each gate kernel an
``nn.Linear`` under the name Flax gives it) and ``Dense_0``, the float32
head.  The cells compute what Flax's cells compute:

- LSTM: input kernels ``ii/if/ig/io`` without bias, hidden kernels
  ``hi/hf/hg/ho`` with bias; ``i = sigmoid(x ii + h hi)``, likewise ``f``
  and ``o``, ``g = tanh(x ig + h hg)``, ``c' = f c + i g``,
  ``h' = o tanh(c')``; the carry is ``(c, h)``.
- GRU: ``ir/iz/in`` with bias, ``hr/hz`` without, ``hn`` with;
  ``r = sigmoid(x ir + h hr)``, ``z`` likewise,
  ``n = tanh(x in + r (h hn + b_hn))``, ``h' = (1 - z) n + z h``.

The carry starts as float32 zeros (Flax's ``param_dtype``) and stays
float32 under a bfloat16 ``compute_dtype``: the products run in the compute
dtype, and ``f * c`` promotes to float32 in both frameworks.

On the card the input projection of all T steps is one GEMM a layer, the
gate kernels concatenated, so the serial loop does one ``[B, H] x [H, G*H]``
product a step.  The cells are eager PyTorch rather than ``nn.LSTM`` /
``nn.GRU``: the window engine ``vmap``s the step over stacked replicas, and
cuDNN's fused RNNs have no batching rule.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from distkeras_torch.models.base import ModelSpec, register_model
from distkeras_torch.models.embedding import _embed_init_
from distkeras_torch.models.mlp import compute_dtype_of, lecun_normal_

LSTM_GATES = ("i", "f", "g", "o")
GRU_GATES = ("r", "z", "n")


class _Cell(nn.Module):
    """One layer's gate kernels: ``i<gate>`` [H, F] and ``h<gate>`` [H, H]
    ``nn.Linear``s, with a bias where Flax's cell has one."""

    gates: Sequence[str] = ()

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = int(hidden)
        for g in self.gates:
            self.add_module(f"i{g}", nn.Linear(in_features, hidden, bias=self._bias("i", g)))
        for g in self.gates:
            self.add_module(f"h{g}", nn.Linear(hidden, hidden, bias=self._bias("h", g)))

    @staticmethod
    def _bias(side: str, gate: str) -> bool:
        return side == "h"                                    # the LSTM's layout

    def reset_parameters(self, gen: torch.Generator) -> None:
        # Flax: lecun_normal input kernels, orthogonal recurrent kernels,
        # zero biases
        for g in self.gates:
            lin = getattr(self, f"i{g}")
            lecun_normal_(lin.weight, lin.weight.shape[1], gen)
            rec = getattr(self, f"h{g}")
            with torch.no_grad():
                nn.init.orthogonal_(rec.weight, generator=gen)
            for layer in (lin, rec):
                if layer.bias is not None:
                    with torch.no_grad():
                        layer.bias.zero_()

    def gate_weights(self, side: str, dtype: torch.dtype):
        layers = [getattr(self, f"{side}{g}") for g in self.gates]
        weight = torch.cat([layer.weight for layer in layers]).to(dtype)
        if layers[0].bias is None:
            return weight, None
        return weight, torch.cat([layer.bias for layer in layers]).to(dtype)

    def project_inputs(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Every step's input projection at once: [B, T, F] -> [B, T, G*H]."""
        weight, bias = self.gate_weights("i", dtype)
        y = F.linear(x.to(dtype), weight)
        return y if bias is None else y + bias


class OptimizedLSTMCell(_Cell):
    gates = LSTM_GATES

    def init_carry(self, x: torch.Tensor):
        zeros = x.new_zeros((x.shape[0], self.hidden), dtype=torch.float32)
        return zeros, zeros

    def step(self, carry, xw: torch.Tensor, hidden, dtype: torch.dtype):
        c, h = carry
        weight, bias = hidden
        gates = F.linear(h.to(dtype), weight) + bias + xw
        # one sigmoid over all four gates (g's is unused): fewer launches
        i, f, _, o = torch.split(torch.sigmoid(gates), self.hidden, -1)
        c = f * c + i * torch.tanh(gates[..., 2 * self.hidden:3 * self.hidden])
        h = o * torch.tanh(c)
        return (c, h), h


class GRUCell(_Cell):
    gates = GRU_GATES

    @staticmethod
    def _bias(side: str, gate: str) -> bool:
        return side == "i" or gate == "n"

    def gate_weights(self, side: str, dtype: torch.dtype):
        if side == "i":
            return super().gate_weights(side, dtype)
        # only hn carries a bias on the hidden side: it sits inside r * (.)
        weight = torch.cat([getattr(self, f"h{g}").weight for g in self.gates]).to(dtype)
        return weight, self.hn.bias.to(dtype)

    def init_carry(self, x: torch.Tensor):
        return x.new_zeros((x.shape[0], self.hidden), dtype=torch.float32)

    def step(self, h, xw: torch.Tensor, hidden, dtype: torch.dtype):
        weight, b_hn = hidden
        hw = F.linear(h.to(dtype), weight)
        two = 2 * self.hidden
        r, z = torch.split(torch.sigmoid(xw[..., :two] + hw[..., :two]), self.hidden, -1)
        n = torch.tanh(xw[..., two:] + r * (hw[..., two:] + b_hn))
        h = (1.0 - z) * n + z * h
        return h, h


_CELLS = {"lstm": OptimizedLSTMCell, "gru": GRUCell}


@register_model("rnn")
class RNNClassifier(nn.Module):
    """Token or feature sequences -> class logits.

    Input is [B, T] integer tokens when ``vocab_size > 0`` (embedded to
    ``embed_dim``), else [B, T, F] float features.  Stacked recurrent layers
    (``cell_type`` "lstm" or "gru"); the last layer's final hidden state
    feeds the float32 dense head (Keras ``return_sequences=False``)."""

    takes_input_shape = True

    def __init__(self, input_shape, vocab_size: int = 0, embed_dim: int = 128,
                 hidden_sizes: Sequence[int] = (128,), cell_type: str = "lstm",
                 num_outputs: int = 2, compute_dtype: Optional[str] = None):
        super().__init__()
        if cell_type not in _CELLS:
            raise ValueError(f"cell_type must be 'lstm' or 'gru', got {cell_type!r}")
        self.dtype = compute_dtype_of(compute_dtype)
        self.vocab_size = int(vocab_size)
        if self.vocab_size:
            self.Embed_0 = nn.Embedding(self.vocab_size, int(embed_dim))
            width = int(embed_dim)
        else:
            width = int(input_shape[-1])
        prefix = "OptimizedLSTMCell" if cell_type == "lstm" else "GRUCell"
        self.cells = []
        for i, h in enumerate(hidden_sizes):
            cell = _CELLS[cell_type](width, int(h))
            self.add_module(f"{prefix}_{i}", cell)
            self.cells.append(cell)
            width = int(h)
        self.Dense_0 = nn.Linear(width, int(num_outputs))

    def reset_parameters(self, gen: torch.Generator) -> None:
        if self.vocab_size:
            _embed_init_(self.Embed_0.weight, gen)
        for cell in self.cells:
            cell.reset_parameters(gen)
        lecun_normal_(self.Dense_0.weight, self.Dense_0.weight.shape[1], gen)
        with torch.no_grad():
            self.Dense_0.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.vocab_size:
            x = F.embedding(x.long(), self.Embed_0.weight).to(dt)
        else:
            x = x.to(dt)
        for i, cell in enumerate(self.cells):
            xw = cell.project_inputs(x, dt)
            hidden = cell.gate_weights("h", dt)
            carry = cell.init_carry(x)
            outs = []
            # unbind, not xw[:, t]: the backward of T slices would add T
            # full-size [B, T, G*H] gradients, that of unbind stacks once
            for xw_t in xw.unbind(1):
                carry, h = cell.step(carry, xw_t, hidden, dt)
                outs.append(h)
            x = h if i == len(self.cells) - 1 else torch.stack(outs, dim=1)
        return F.linear(x.float(), self.Dense_0.weight, self.Dense_0.bias)


def lstm_classifier_spec(vocab_size: int = 1024, seq_len: int = 64,
                         embed_dim: int = 128, hidden_sizes: Sequence[int] = (128,),
                         num_outputs: int = 2, cell_type: str = "lstm") -> ModelSpec:
    """Token-sequence classifier (IMDB-style sentiment shapes)."""
    return ModelSpec(
        name="rnn",
        config={"vocab_size": vocab_size, "embed_dim": embed_dim,
                "hidden_sizes": tuple(hidden_sizes), "cell_type": cell_type,
                "num_outputs": num_outputs},
        input_shape=(seq_len,),
        input_dtype="int32",
    )


def feature_rnn_spec(seq_len: int = 32, feature_dim: int = 8,
                     hidden_sizes: Sequence[int] = (64,), num_outputs: int = 2,
                     cell_type: str = "gru") -> ModelSpec:
    """Float-feature sequence classifier (sensor/time-series shapes)."""
    return ModelSpec(
        name="rnn",
        config={"vocab_size": 0, "hidden_sizes": tuple(hidden_sizes),
                "cell_type": cell_type, "num_outputs": num_outputs},
        input_shape=(seq_len, feature_dim),
    )

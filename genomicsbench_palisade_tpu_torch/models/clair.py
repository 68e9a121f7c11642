"""Clair variant-caller network (nn-variant) as a torch module.

The port's counterpart of genomicsbench_palisade_tpu/models/clair.py.
Architecture: benchmarks/nn-variant/clair/model.py:330-640 ("2BiLSTM")
with shared/param.py's shapes:
  input [B, 33, 8, 4] (2*16+1 positions x matrixRow x matrixNum)
  -> 33 positions x 32 features -> BiLSTM(128) -> BiLSTM(128)
  -> per-channel slice-dense over the 256 channels (33 -> 30 units, selu)
  -> flatten (30*256) -> dense 192 selu
  -> four heads dense 96 selu -> dense (selu on the logits) -> softmax:
     gt21 (21), genotype (3), indel length 1 (33), indel length 2 (33).

The BiLSTMs are bidirectional `torch.nn.LSTM`s from a zero carry (torch's
gate order i, f, g, o with bias_ih and bias_hh).  Inference is
dropout-free (the reference's dropouts are training-only).  Everything
runs in float32 with TF32 off.  `load_tf_variables` maps the reference's
TF1 variables straight into the state dict; `convert.clair_state_from_flax`
maps the JAX package's params.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..utils.precision import ieee_fp32

FLANKING = 16
POSITIONS = 2 * FLANKING + 1  # 33
MATRIX_ROW = 8
MATRIX_NUM = 4
GT21 = 21
GENOTYPE = 3
VARLEN = 33  # 2*16 + 1
HEAD_SIZES = (GT21, GENOTYPE, VARLEN, VARLEN)
UNITS = 128


class BiLSTM(nn.LSTM):
    """[B, T, F] -> [B, T, 2 * units]: forward and backward outputs side by
    side, each from a zero carry."""

    def __init__(self, in_features, units=UNITS):
        super().__init__(in_features, units, batch_first=True, bidirectional=True)

    def forward(self, x):
        return super().forward(x)[0]


class ClairModel(nn.Module):
    def __init__(self, lstm_units=UNITS, slice_units=30, l4_units=192, l5_units=96):
        super().__init__()
        ch = 2 * lstm_units
        self.lstm1 = BiLSTM(MATRIX_ROW * MATRIX_NUM, lstm_units)
        self.lstm2 = BiLSTM(ch, lstm_units)
        self.l3_kernel = nn.Parameter(torch.zeros(ch, POSITIONS, slice_units))
        self.l3_bias = nn.Parameter(torch.zeros(ch, slice_units))
        self.l4 = nn.Linear(slice_units * ch, l4_units)
        for i, out in enumerate(HEAD_SIZES):
            setattr(self, f"l5_{i + 1}", nn.Linear(l4_units, l5_units))
            setattr(self, f"y_{i + 1}", nn.Linear(l5_units, out))

    def forward(self, x):
        """[B, 33, 8, 4] -> the four softmax heads, each [B, size]."""
        b = x.shape[0]
        with ieee_fp32():
            h = x.reshape(b, POSITIONS, MATRIX_ROW * MATRIX_NUM).to(torch.float32)
            h = self.lstm2(self.lstm1(h))  # [B, 33, 256]
            # slice-dense over the feature axis: per channel, dense 33 -> 30
            # (model.py:226-244 with slice_dimension=2)
            l3 = torch.selu(torch.einsum("bcp,cpu->bcu", h.transpose(1, 2), self.l3_kernel)
                            + self.l3_bias)  # [B, 256, 30]
            l4 = torch.selu(self.l4(l3.transpose(1, 2).reshape(b, -1)))  # flatten as (30, 256)
            heads = []
            for i in range(len(HEAD_SIZES)):
                l5 = torch.selu(getattr(self, f"l5_{i + 1}")(l4))
                # the reference applies selu AS THE ACTIVATION of the logits
                # dense before the softmax (model.py:581-588 activation=selu)
                heads.append(torch.softmax(torch.selu(getattr(self, f"y_{i + 1}")(l5)), dim=-1))
        return tuple(heads)


def init_model(seed=0, device="cpu") -> ClairModel:
    """A model with seeded random weights (torch.Generator): LSTM and dense
    kernels N(0, 1/fan_in), biases 0."""
    model = ClairModel()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "bias" in name:
                p.zero_()
            else:  # [out, in] and l3's [channel, in, out]: fan_in is shape[1]
                p.copy_(torch.randn(p.shape, generator=gen) / p.shape[1] ** 0.5)
    return model.eval().to(device)


# ---------------------------------------------------------------------------
# TF1 checkpoint conversion
# ---------------------------------------------------------------------------

_LSTM_SCOPE = ("{scope}/stack_bidirectional_rnn/cell_0/bidirectional_rnn/"
               "{direction}/cudnn_compatible_lstm_cell")
_TF_TO_TORCH_GATES = (0, 2, 1, 3)  # TF's fused (i, c, f, o) blocks in torch's (i, f, g, o) order
_HEAD_NAMES = ("Y_base_change_logits", "Y_genotype_logits", "Y_indel_length_logits_1",
               "Y_indel_length_logits_2")


def _gates(a, units):
    """The last axis's four gate blocks of TF's order in torch's order."""
    return np.concatenate([a[..., g * units : (g + 1) * units] for g in _TF_TO_TORCH_GATES], -1)


def load_tf_variables(variables: dict, units: int = UNITS) -> dict:
    """A Clair TF1 variable map (name -> array) as the port's state dict.

    The reference graph (model.py:423-640, tf.contrib.rnn.
    stack_bidirectional_dynamic_rnn over CudnnCompatibleLSTMCell) keeps an
    LSTM's kernel as [(input + units), 4*units] in gate order (i, c, f, o)
    with one fused bias and forget_bias 0; the slice-dense units live at
    L3/Unit_{c}, the heads at L5_{k} and Prediction/Y_*_logits."""
    state = {}
    for scope, ours in (("LSTM1", "lstm1"), ("LSTM2", "lstm2")):
        for direction, suffix in (("fw", ""), ("bw", "_reverse")):
            tf_scope = _LSTM_SCOPE.format(scope=scope, direction=direction)
            kernel = np.asarray(variables[tf_scope + "/kernel"], np.float32)
            n_in = kernel.shape[0] - units
            state[f"{ours}.weight_ih_l0{suffix}"] = _gates(kernel[:n_in], units).T
            state[f"{ours}.weight_hh_l0{suffix}"] = _gates(kernel[n_in:], units).T
            # the fused bias rides on the hidden side, as the JAX conversion puts it
            state[f"{ours}.bias_ih_l0{suffix}"] = np.zeros(4 * units, np.float32)
            state[f"{ours}.bias_hh_l0{suffix}"] = _gates(
                np.asarray(variables[tf_scope + "/bias"], np.float32), units)
    ch = 2 * units
    state["l3_kernel"] = np.stack([np.asarray(variables[f"L3/Unit_{c}/kernel"]) for c in range(ch)])
    state["l3_bias"] = np.stack([np.asarray(variables[f"L3/Unit_{c}/bias"]) for c in range(ch)])
    dense = {"l4": "L4", **{f"l5_{k + 1}": f"L5_{k + 1}" for k in range(4)},
             **{f"y_{k + 1}": f"Prediction/{_HEAD_NAMES[k]}" for k in range(4)}}
    for ours, tf_name in dense.items():
        state[f"{ours}.weight"] = np.asarray(variables[tf_name + "/kernel"]).T
        state[f"{ours}.bias"] = np.asarray(variables[tf_name + "/bias"])
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in state.items()}

"""Bonito QuartzNet-style CTC basecaller (nn-base) as a torch module.

The port's counterpart of genomicsbench_palisade_tpu/models/bonito.py.
Architecture: benchmarks/nn-base/bonito/basecall.py:33-260 and
models/bonito_dna_r941/config.toml: 8 blocks of time-channel-separable 1-D
convolutions with BatchNorm (eps 1e-3) and Swish, pointwise residuals, a
1x1 decoder convolution and log_softmax over "NACGT" (0 = the CTC blank).

The modules work on [B, C, T] and name their parameters as the reference
checkpoint does (`encoder.encoder.{i}.conv.{idx}.depthwise.weight`,
`...residual.0.conv.weight`, `decoder.layers.0.weight`), so a reference
`weights_<N>.tar` loads with `load_reference_state` (`module.` stripped).
Inference only: BatchNorm is its running-statistics form, computed as
flax's is (`(x - mean) * (rsqrt(var + eps) * scale) + bias`, in float32 on
the convolution's output, then rounded to the stack's dtype); dropout is
the identity.  With dtype bfloat16 (the reference driver's half precision)
the convolutions, Swish and residual sums run in bf16 and the decoder and
log_softmax in float32; at float32 everything runs with TF32 off.

The host side (`norm_by_noisiest_section`, `chunk_signal`, `stitch`,
`viterbi_decode`, `beam_search_decode`) follows basecall.py:296-398 and
the JAX module.  The CTC beam search runs the JAX package's native beam
(`io.native.ctc_beam_native`, native/ctc_beam.cpp), as the JAX module
does; its Python spec walk (the same construction order and tie-breaks)
is the plain version (`use_native=False`).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..io.native import ctc_beam_native
from ..utils.precision import ieee_fp32

DEFAULT_ALPHABET = "NACGT"

# (filters, repeat, kernel, stride, residual, separable) per config.toml
DNA_R941_BLOCKS = [
    (344, 1, 9, 3, False, False),
    (424, 2, 115, 1, True, True),
    (464, 7, 5, 1, True, True),
    (456, 4, 123, 1, True, True),
    (440, 9, 9, 1, True, True),
    (280, 6, 31, 1, True, True),
    (384, 1, 67, 1, False, True),
    (48, 1, 15, 1, False, False),
]
MODEL_STRIDE = DNA_R941_BLOCKS[0][3]  # block 0 stride (config stride=3)
BN_EPS = 1e-3


def swish(x):
    return x * torch.sigmoid(x)


def _conv(conv: nn.Conv1d, x):
    """conv's weights in x's dtype (flax's dtype promotion)."""
    return F.conv1d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding,
                    conv.dilation, conv.groups)


def batch_norm(bn: nn.BatchNorm1d, x):
    """Inference-form BatchNorm as flax computes it, in float32, rounded
    to x's dtype."""
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    y = (x.to(torch.float32) - bn.running_mean[:, None]) * mul[:, None] + bn.bias[:, None]
    return y.to(x.dtype)


class TCSConv(nn.Module):
    """Time-channel-separable convolution, padding k//2 on both sides."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, separable=False):
        super().__init__()
        pad = kernel_size // 2
        self.separable = separable
        if separable:
            self.depthwise = nn.Conv1d(in_channels, in_channels, kernel_size, stride, pad,
                                       groups=in_channels, bias=False)
            # reference quirk: the pointwise conv also carries the stride
            self.pointwise = nn.Conv1d(in_channels, out_channels, 1, stride, bias=False)
        else:
            self.conv = nn.Conv1d(in_channels, out_channels, kernel_size, stride, pad,
                                  bias=False)

    def forward(self, x):
        if self.separable:
            return _conv(self.pointwise, _conv(self.depthwise, x))
        return _conv(self.conv, x)


class Block(nn.Module):
    """`repeat` x (TCSConv, BatchNorm[, Swish, Dropout]) and an optional
    pointwise residual: the reference's module indices, so its names."""

    def __init__(self, in_channels, out_channels, repeat, kernel_size, stride, residual,
                 separable):
        super().__init__()
        layers, c = [], in_channels
        for r in range(repeat):
            layers += [TCSConv(c, out_channels, kernel_size, stride, separable),
                       nn.BatchNorm1d(out_channels, eps=BN_EPS)]
            if r < repeat - 1:
                layers += [nn.SiLU(), nn.Dropout()]  # parameter-free: keep the indices
            c = out_channels
        self.conv = nn.ModuleList(layers)
        self.residual = (nn.ModuleList([TCSConv(in_channels, out_channels, 1),
                                        nn.BatchNorm1d(out_channels, eps=BN_EPS)])
                         if residual else None)

    def forward(self, x):
        h = x
        for i in range(0, len(self.conv), 4):
            h = batch_norm(self.conv[i + 1], self.conv[i](h))
            if i + 2 < len(self.conv):
                h = swish(h)
        if self.residual is not None:
            h = h + batch_norm(self.residual[1], self.residual[0](x))
        return swish(h)


class _Encoder(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        layers, c = [], 1
        for f, rep, k, s, res, sep in blocks:
            layers.append(Block(c, f, rep, k, s, res, sep))
            c = f
        self.encoder = nn.Sequential(*layers)


class _Decoder(nn.Module):
    def __init__(self, features, n_classes):
        super().__init__()
        self.layers = nn.Sequential(nn.Conv1d(features, n_classes, 1, bias=True))


class BonitoModel(nn.Module):
    """[B, 1, T] normalised signal -> [B, ceil(T / stride), n_classes]
    log-probabilities (float32).  `dtype` bfloat16 runs the encoder in bf16
    (the reference driver's half precision); the decoder stays float32."""

    def __init__(self, blocks=tuple(DNA_R941_BLOCKS), n_classes=5, dtype=torch.float32):
        super().__init__()
        self.blocks = tuple(blocks)
        self.dtype = dtype
        self.encoder = _Encoder(self.blocks)
        self.decoder = _Decoder(self.blocks[-1][0], n_classes)

    def forward(self, x):
        with ieee_fp32():
            h = x.to(self.dtype)
            for block in self.encoder.encoder:
                h = block(h)
            conv = self.decoder.layers[0]
            h = F.conv1d(h.to(torch.float32), conv.weight, conv.bias)
            return torch.log_softmax(h.transpose(1, 2), dim=-1)


def init_model(seed=0, blocks=None, dtype=torch.float32, device="cpu") -> BonitoModel:
    """A model with seeded random weights (torch.Generator): convolution
    kernels N(0, 1/fan_in), the decoder's bias 0, BatchNorm the identity."""
    model = BonitoModel(blocks=tuple(blocks or DNA_R941_BLOCKS), dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv1d):
                fan_in = m.weight.shape[1] * m.weight.shape[2]
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) / fan_in ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
    return model.eval().to(device)


def load_reference_state(model: BonitoModel, state_dict) -> BonitoModel:
    """Load a reference bonito state dict (numpy arrays or tensors; any
    `module.` prefix stripped).  Only BatchNorm's `num_batches_tracked`
    may be missing."""
    state = {k.replace("module.", ""): torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()}
    res = model.load_state_dict(state, strict=False)
    missing = [k for k in res.missing_keys if not k.endswith("num_batches_tracked")]
    if missing or res.unexpected_keys:
        raise ValueError(f"state dict does not fit the model: missing {missing}, "
                         f"unexpected {res.unexpected_keys}")
    return model


# ---------------------------------------------------------------------------
# host-side signal preprocessing, chunking and decoding (basecall.py:296-398)
# ---------------------------------------------------------------------------


def med_mad(x, factor=1.4826):
    """Median and scaled median absolute deviation (basecall.py:391-397)."""
    med = np.median(x)
    mad = np.median(np.absolute(x - med)) * factor
    return med, mad


def norm_by_noisiest_section(signal, samples=100, threshold=6.0):
    """medmad-normalise using the widest high-noise region
    (basecall.py:367-388); the windows' deviations in one reduction."""
    from scipy.signal import find_peaks

    signal = np.asarray(signal, dtype=np.float32)
    thr = signal.std() / threshold
    noise = np.ones(signal.shape)
    n_win = signal.shape[0] // samples
    noise[: n_win * samples] = np.repeat(
        np.where(signal[: n_win * samples].reshape(n_win, samples).std(1) > thr, 1, 0), samples)
    noise[0] = 0
    noise[-1] = 0
    peaks, info = find_peaks(noise, width=(None, None))
    if len(peaks):
        widest = np.argmax(info["widths"])
        med, mad = med_mad(signal[info["left_bases"][widest]: info["right_bases"][widest]])
    else:
        med, mad = med_mad(signal)
    return (signal - med) / mad


def chunk_signal(raw, chunksize, overlap):
    """Overlapping chunks [N, chunksize] (basecall.py chunk(), :295-305)."""
    raw = np.asarray(raw, dtype=np.float32)
    if chunksize > 0 and raw.shape[0] > chunksize:
        step = chunksize - overlap
        num_chunks = raw.shape[0] // step + 1
        tmp = np.zeros(num_chunks * step, dtype=raw.dtype)
        tmp[: raw.shape[0]] = raw
        n_windows = (len(tmp) - chunksize) // step + 1
        idx = np.arange(n_windows)[:, None] * step + np.arange(chunksize)[None, :]
        return tmp[idx]
    return raw[None, :]


def stitch(predictions, overlap_out):
    """Stitch chunked posteriors (basecall.py stitch(), :308-316); numpy
    arrays or tensors (kept on their device)."""
    cat = torch.cat if isinstance(predictions, torch.Tensor) else np.concatenate
    if predictions.shape[0] == 1:
        return predictions[0]
    if overlap_out == 0:
        return cat(list(predictions))
    pieces = [predictions[0, :-overlap_out]]
    for i in range(1, predictions.shape[0] - 1):
        pieces.append(predictions[i][overlap_out:-overlap_out])
    pieces.append(predictions[-1][overlap_out:])
    return cat(pieces)


def viterbi_decode(log_probs, alphabet=DEFAULT_ALPHABET):
    """Greedy CTC collapse: the argmax path (on log_probs' device for a
    tensor) with repeats and blanks (label 0) removed."""
    if isinstance(log_probs, torch.Tensor):
        path = log_probs.argmax(-1).cpu().numpy()
    else:
        path = np.argmax(np.asarray(log_probs), axis=-1)
    keep = path != 0
    keep[1:] &= path[1:] != path[:-1]
    return np.frombuffer(alphabet.encode(), np.uint8)[path[keep]].tobytes().decode()


def beam_search_decode(log_probs, alphabet=DEFAULT_ALPHABET, beam_size=5, threshold=1e-3,
                       use_native: bool = True):
    """CTC prefix beam search (the reference's fast_ctc_decode beam_search
    path, basecall.py:100-105, default beamsize=5 threshold=1e-3): label 0
    is the blank, per-step classes below `threshold` posterior are pruned,
    beams keep (p_blank, p_nonblank) mass per collapsed prefix.  The native
    beam, or with `use_native=False` the JAX module's Python walk, step for
    step, in float64."""
    if isinstance(log_probs, torch.Tensor):
        log_probs = log_probs.cpu().numpy()
    if use_native:
        labels = ctc_beam_native(np.asarray(log_probs, np.float32), beam_size, threshold)
        return "".join(alphabet[c] for c in labels)
    probs = np.exp(np.asarray(log_probs, np.float64))
    beams = {(): (1.0, 0.0)}
    for p_t in probs.tolist():
        live = [c for c, p in enumerate(p_t) if p >= threshold]
        nxt = {}
        for prefix, (pb, pnb) in beams.items():
            last = prefix[-1] if prefix else -1
            for c in live:
                p = p_t[c]
                if c == 0:  # blank extends every prefix unchanged
                    b0, n0 = nxt.get(prefix, (0.0, 0.0))
                    nxt[prefix] = (b0 + (pb + pnb) * p, n0 + 0.0)
                elif c == last:
                    b0, n0 = nxt.get(prefix, (0.0, 0.0))
                    nxt[prefix] = (b0 + 0.0, n0 + pnb * p)  # repeat collapses
                    ext = prefix + (c,)
                    b0, n0 = nxt.get(ext, (0.0, 0.0))
                    nxt[ext] = (b0 + 0.0, n0 + pb * p)  # blank-separated
                else:
                    ext = prefix + (c,)
                    b0, n0 = nxt.get(ext, (0.0, 0.0))
                    nxt[ext] = (b0 + 0.0, n0 + (pb + pnb) * p)
        beams = dict(sorted(nxt.items(), key=lambda kv: -(kv[1][0] + kv[1][1]))[:beam_size])
        if not beams:  # every class pruned this step: keep prior beams
            beams = {(): (1.0, 0.0)}
    best = max(beams.items(), key=lambda kv: kv[1][0] + kv[1][1])[0]
    return "".join(alphabet[c] for c in best)


def _model_device(model):
    return next(model.parameters()).device


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def basecall_read(model, signal, chunksize=4000, overlap=0, stride=MODEL_STRIDE, beamsize=1,
                  timings: dict | None = None):
    """One read: chunk -> one batched forward on the model's device ->
    stitch the posteriors -> decode (beamsize > 1: the prefix beam search,
    1: viterbi).  `timings` accumulates forward_s, decode_s and beam_s."""
    dev = _model_device(model)
    t0 = time.perf_counter()
    chunks = torch.from_numpy(chunk_signal(signal, chunksize, overlap)[:, None, :]).to(dev)
    with torch.no_grad():
        lp = model(chunks)
    if timings is not None:
        _sync(dev)
    t1 = time.perf_counter()
    posteriors = stitch(lp, overlap // stride // 2)[: len(signal)]
    seq = (beam_search_decode(posteriors, beam_size=beamsize) if beamsize > 1
           else viterbi_decode(posteriors))
    if timings is not None:
        key = "beam_s" if beamsize > 1 else "decode_s"
        timings["forward_s"] = timings.get("forward_s", 0.0) + t1 - t0
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - t1
    return seq


def basecall(model, signal, chunksize=4000, overlap=0):
    """Chunked single-read basecall, a forward and a viterbi collapse a
    chunk; returns the called sequence."""
    dev = _model_device(model)
    pieces = []
    for s in range(0, len(signal), chunksize - overlap):
        chunk = signal[s : s + chunksize]
        if len(chunk) < chunksize:
            chunk = np.pad(chunk, (0, chunksize - len(chunk)))
        x = torch.as_tensor(np.asarray(chunk, np.float32)[None, None, :], device=dev)
        with torch.no_grad():
            pieces.append(viterbi_decode(model(x)[0]))
    return "".join(pieces)

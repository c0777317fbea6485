"""The plain reference of each cell's timed path, stage by stage, over the
benchmark's own weights (benchmark/lib/model.py) and inputs.

`Batch`: audio -> spikes -> reservoir statistics -> features -> scaler ->
logits, each stage callable alone so that a check can start one from the
program's output of the stage before (the reservoir is chaotic: see
benchmark/lib/check.py). `Stream`: one hop of the continuous engine from a
carried state, every leaf as the program carries it; `init_state` is a
fresh stream's. Both run in blocks of rows so that 2400 utterances or 1024
streams fit beside whatever the card still holds.

`lower=True` makes the control: the reference in the nearest precision
below each that the configuration states (the cascade's and the readout's
float32 products with TF32 on, the reservoir's bf16 weights in fp8 and its
float32 membrane in bf16).
"""

from __future__ import annotations

import torch

from benchmark.reference.frontend import Frontend, to_tf32
from benchmark.reference.reservoir import SEG_KEYS, Reservoir, features, fold


def _precise():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Readout:
    """Standardize with the scaler, then the logistic readout's logits; with
    `lower`, the product with TF32 on."""

    def __init__(self, weights: dict, lower: bool = False):
        self.q = to_tf32 if lower else (lambda t: t)
        self.mean, self.scale = weights["scaler_mean"], weights["scaler_scale"]
        self.w, self.b = self.q(weights["readout_w"]), weights["readout_b"]

    def __call__(self, feats: torch.Tensor) -> torch.Tensor:
        return self.q((feats - self.mean) / self.scale) @ self.w + self.b


class Batch:
    """flagship-style batch classification."""

    def __init__(self, config: dict, weights: dict, device, lower: bool = False,
                 rows: int = 600):
        _precise()
        self.config, self.rows = config, rows
        self.frontend = Frontend(config["frontend"], device, lower)
        self.reservoir = Reservoir(config["reservoir"], weights, lower)
        self.keys = tuple(config["feature_keys"])
        self.readout = Readout(weights, lower)

    def _blocks(self, x, fn):
        return torch.cat([fn(x[i:i + self.rows]) for i in range(0, x.shape[0], self.rows)])

    def spikes(self, audio: torch.Tensor) -> torch.Tensor:
        return self._blocks(audio, self.frontend.batch)

    def features(self, spikes: torch.Tensor) -> torch.Tensor:
        return self._blocks(spikes, lambda x: features(self.reservoir.stats(x)[0], self.keys))

    def fired(self, spikes: torch.Tensor):
        """(fired recurrent rows, input spikes) of these utterances."""
        rec = inp = 0.0
        for i in range(0, spikes.shape[0], self.rows):
            _, r, s = self.reservoir.stats(spikes[i:i + self.rows])
            rec, inp = rec + r, inp + s
        return rec, inp

    def logits(self, feats: torch.Tensor) -> torch.Tensor:
        return self.readout(feats)

    def step(self, audio: torch.Tensor, events=None) -> dict:
        """The whole path, as the program's stand-in (the control)."""
        sp = self.spikes(audio)
        f = self.features(sp)
        return {"spikes": sp, "features": f, "preds": torch.argmax(self.logits(f), dim=-1)}


class Stream:
    """The continuous engine at `chunk_len` samples a hop."""

    def __init__(self, config: dict, weights: dict, device, chunk_len: int, decay: float,
                 lower: bool = False, rows: int = 256):
        _precise()
        self.config, self.rows, self.device = config, rows, device
        f = config["frontend"]
        self.frontend = Frontend(f, device, lower)
        self.reservoir = Reservoir(config["reservoir"], weights, lower)
        self.keys = tuple(config["feature_keys"])
        self.readout = Readout(weights, lower)
        self.decay = decay
        n_thr = len(f["spike_thresholds"])
        n_cols = chunk_len // self.frontend.hop
        self.t_c = n_cols * n_thr
        t_win = f["time_bins"] * n_thr
        self.n_ring = t_win // self.t_c
        self.win_len = t_win // self.reservoir.n_win
        self.n_new_win = self.t_c // self.win_len

    def init_state(self, n: int) -> dict:
        """A fresh stream's leaves ("no observation yet")."""
        f, r, dev = self.config["frontend"], self.reservoir, self.device
        C, no, w = f["n_filters"], r.n_outputs, r.width
        fr = self.frontend
        segs = {k: torch.zeros(self.n_ring, n, no, device=dev) for k in SEG_KEYS}
        segs["first"].fill_(float("inf"))
        segs["last"].fill_(-1.0)
        return dict(
            iir=torch.zeros(n, 8, C, device=dev),
            tail=torch.zeros(fr.w_per - fr.h_per, n, C, device=dev),
            hyst=torch.zeros(n, len(f["spike_thresholds"]), C, dtype=torch.bool, device=dev),
            norm_hi=torch.full((n,), -1e30, device=dev), norm_lo=torch.full((n,), 1e30, device=dev),
            v=torch.zeros(n, w, device=dev), refrac=torch.zeros(n, w, dtype=torch.int32, device=dev),
            s_prev=torch.zeros(n, w, device=dev),
            segs=segs, win_ring=torch.zeros(n, no, self.reservoir.n_win, device=dev))

    def hop(self, st: dict, chunk: torch.Tensor):
        """(new state, logits (B, K), fired recurrent rows, input spikes)
        of one hop of a (B, L) int16 chunk from state `st`."""
        out, logits, rec, inp = [], [], 0.0, 0.0
        for i in range(0, chunk.shape[0], self.rows):
            rows = slice(i, i + self.rows)
            part = {k: (v[:, rows] if k == "tail" else v[rows]) for k, v in st.items()
                    if k != "segs"}
            part["segs"] = {k: v[:, rows] for k, v in st["segs"].items()}
            new, lg, r, s = self._hop(part, chunk[rows])
            out.append(new)
            logits.append(lg)
            rec, inp = rec + r, inp + s
        cat = {k: torch.cat([o[k] for o in out], dim=1 if k == "tail" else 0)
               for k in out[0] if k != "segs"}
        cat["segs"] = {k: torch.cat([o["segs"][k] for o in out], dim=1) for k in SEG_KEYS}
        return cat, torch.cat(logits), rec, inp

    def _hop(self, st: dict, chunk: torch.Tensor):
        audio = chunk.float() / 32768.0 if chunk.dtype == torch.int16 else chunk.float()
        spikes, fe = self.frontend.chunk(audio, st, self.decay)
        v, refrac, s, seg, win, rec, inp = self.reservoir.chunk(
            spikes, st["v"], st["refrac"], st["s_prev"], self.win_len, self.n_new_win)
        segs = {k: torch.cat([st["segs"][k][1:], seg[k][None]], dim=0) for k in SEG_KEYS}
        win_ring = torch.cat([st["win_ring"][..., self.n_new_win:], win.transpose(1, 2)], dim=-1)
        stats = fold(segs, self.t_c, self.reservoir.burst_isi_max)
        stats["win_counts"] = win_ring
        logits = self.readout(features(stats, self.keys))
        new = dict(fe, v=v, refrac=refrac, s_prev=s, segs=segs, win_ring=win_ring)
        return new, logits, rec, inp

"""Plain reference of the LIF reservoir and its statistics.

    v_t = (1 - leak) v_{t-1} + s_{t-1} @ W_rec + x_t @ W_in   (while not refractory)
    s_t = v_t >= threshold;  v_t = 0 and refractory countdown on a spike

The configuration's precision: weights rounded to bf16 and widened to f32,
every product and sum in f32 (TF32 off), f32 state. With `lower`, the
control's precision: the weights in fp8 (e4m3, one scale a matrix) and the
membrane stored in bf16 after every step.
The drive of a dense reservoir is one f32 matmul; of a block-sparse one,
per destination block, the sum over its slots of the named source block's
spikes times the slot's 128 x 128 block. The batch statistics, the segment
summary of a continuous chunk, the fold of a ring of summaries and the
feature vectors follow lsm_tpu_torch's plain twins and
models/reservoir.py, which they copy; nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict

import torch

STAT_KEYS = ("counts", "sum_t", "sum_t2", "first", "last", "n_isi", "sum_isi",
             "sum_isi2", "bursts", "win_sum", "win_sum2")
SEG_KEYS = STAT_KEYS[:9]
BLOCK = 128


def fp8(w: torch.Tensor) -> torch.Tensor:
    """w stored in float8 e4m3 with one scale for the matrix (its largest
    magnitude at the format's largest, 448), widened again."""
    s = w.abs().amax().clamp_min(1e-30) / 448.0
    return (w / s).to(torch.float8_e4m3fn).float() * s


class Reservoir:
    """The configuration's reservoir over the benchmark's weights (the
    arrays of benchmark/lib/model.py), on their device."""

    def __init__(self, r: dict, w: dict, lower: bool = False):
        self.sparse = "w_blocks" in w
        q = fp8 if lower else (lambda t: t.to(torch.bfloat16).float())
        if self.sparse:
            self.w_blocks = q(w["w_blocks"])
            self.src_idx = w["src_idx"].long()
        else:
            self.w_rec = q(w["w_rec"])
        self.w_in = q(w["w_in"])
        self.keep = 1.0 - w["leak"]
        self.width = self.keep.shape[0]
        self.threshold = float(r["membrane_threshold"])
        self.refractory = int(r["refractory_period"])
        self.burst_isi_max = int(r["burst_isi_max"])
        self.n_outputs = int(r["num_output_neurons"])
        self.n_win = int(r["n_rate_windows"])
        self.lower = lower

    def drive(self, s: torch.Tensor) -> torch.Tensor:
        if not self.sparse:
            return s @ self.w_rec
        B = s.shape[0]
        nb, S = self.src_idx.shape
        g = s.reshape(B, -1, BLOCK)[:, self.src_idx.reshape(-1)]
        g = g.reshape(B, nb, S * BLOCK).transpose(0, 1)
        out = torch.bmm(g, self.w_blocks.reshape(nb, S * BLOCK, BLOCK))
        return out.transpose(0, 1).reshape(B, nb * BLOCK)

    def step(self, v, refrac, s, x_t):
        """One step: (v, refrac int32, spikes bool) from the state and the
        (B, C_pad) f32 input column."""
        drive = self.drive(s) + x_t @ self.w_in
        active = refrac == 0
        v_new = torch.where(active, v * self.keep + drive, 0.0)
        if self.lower:
            v_new = v_new.to(torch.bfloat16).float()
        spike = (v_new >= self.threshold) & active
        refrac = torch.where(spike, self.refractory, torch.clamp(refrac - 1, min=0))
        return torch.where(spike, 0.0, v_new), refrac.to(torch.int32), spike

    def _input(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T = x.shape
        xf = torch.zeros(B, self.w_in.shape[0], T, dtype=torch.float32, device=x.device)
        xf[:, :C] = x.float()
        return xf

    def stats(self, x: torch.Tensor):
        """Whole utterances from a zero state: x (B, C, T) 0/1 -> (stats
        dict of (B, no), spikes of every neuron a step summed over the
        steps that drive a next one (the fired recurrent rows), input
        spikes)."""
        B, C, T = x.shape
        no, dev = self.n_outputs, x.device
        win_len = max(1, T // self.n_win)
        xf = self._input(x)
        v = torch.zeros(B, self.width, device=dev)
        s = torch.zeros(B, self.width, device=dev)
        refrac = torch.zeros(B, self.width, dtype=torch.int32, device=dev)
        st = {k: torch.zeros(B, no, device=dev) for k in STAT_KEYS}
        st["first"].fill_(float("inf"))
        st["last"].fill_(-1.0)
        prev_t = torch.full((B, no), -1.0, device=dev)
        c_cur = torch.zeros(B, no, device=dev)
        fired_rows = torch.zeros((), dtype=torch.float64, device=dev)
        for t in range(T):
            v, refrac, spike = self.step(v, refrac, s, xf[:, :, t])
            s = spike.float()
            if t < T - 1:
                fired_rows += s.sum(dtype=torch.float64)
            so, sb, tf = s[:, :no], spike[:, :no], float(t)
            st["counts"] += so
            st["sum_t"] += so * tf
            st["sum_t2"] += so * tf * tf
            st["first"] = torch.minimum(st["first"], torch.where(sb, tf, float("inf")))
            st["last"] = torch.maximum(st["last"], torch.where(sb, tf, -1.0))
            isi = tf - prev_t
            ev = sb & (prev_t >= 0.0)
            isi_f = torch.where(ev, isi, 0.0)
            st["n_isi"] += ev.float()
            st["sum_isi"] += isi_f
            st["sum_isi2"] += isi_f * isi_f
            st["bursts"] += (ev & (isi <= self.burst_isi_max)).float()
            prev_t = torch.where(sb, tf, prev_t)
            c_cur += so
            if ((t + 1) % win_len == 0 and (t + 1) // win_len < self.n_win) or t == T - 1:
                st["win_sum"] += c_cur
                st["win_sum2"] += c_cur * c_cur
                c_cur = torch.zeros(B, no, device=dev)
        st["n_win_used"] = float(self.n_win)
        return st, float(fired_rows), float(x.sum(dtype=torch.float64))

    def chunk(self, x: torch.Tensor, v, refrac, s_prev, win_len: int, n_new_win: int):
        """One continuous chunk from the carried (v, refrac, s_prev): -> (v,
        refrac, s_prev, segment summary dict, window counts (B, n_new_win,
        no), fired recurrent rows (the carried spikes and those of every
        step but the last), input spikes)."""
        B, C, T = x.shape
        no = self.n_outputs
        xf = self._input(x)
        raster = torch.empty(B, T, no, dtype=torch.bool, device=x.device)
        s = s_prev
        fired_rows = s_prev.sum(dtype=torch.float64)
        for t in range(T):
            v, refrac, spike = self.step(v, refrac, s, xf[:, :, t])
            s = spike.float()
            if t < T - 1:
                fired_rows += s.sum(dtype=torch.float64)
            raster[:, t] = spike[:, :no]
        seg = segment_summary(raster, self.burst_isi_max)
        win = raster.float().view(B, n_new_win, win_len, no).sum(dim=2)
        return v, refrac, s, seg, win, float(fired_rows), float(x.sum(dtype=torch.float64))


def segment_summary(raster: torch.Tensor, burst_isi_max: int) -> Dict[str, torch.Tensor]:
    """(B, T, no) bool output raster -> statistics with segment-relative
    times; the ISI moments of the pairs inside the segment."""
    B, T, no = raster.shape
    sof = raster.float()
    tf = torch.arange(T, dtype=torch.float32, device=raster.device).view(1, T, 1)
    marks = torch.where(raster, tf, -1.0)
    m = torch.cummax(marks, dim=1).values
    prev_t = torch.cat([torch.full_like(m[:, :1], -1.0), m[:, :-1]], dim=1)
    ev = raster & (prev_t >= 0.0)
    isi = torch.where(ev, tf - prev_t, 0.0)
    return dict(
        counts=sof.sum(dim=1), sum_t=(sof * tf).sum(dim=1), sum_t2=(sof * tf * tf).sum(dim=1),
        first=torch.where(raster, tf, float("inf")).amin(dim=1), last=marks.amax(dim=1),
        n_isi=ev.float().sum(dim=1), sum_isi=isi.sum(dim=1), sum_isi2=(isi * isi).sum(dim=1),
        bursts=(ev & (isi <= burst_isi_max)).float().sum(dim=1),
    )


def fold(segs: Dict[str, torch.Tensor], seg_len: int, burst_isi_max: int) -> Dict[str, torch.Tensor]:
    """A ring of segment summaries (n_ring, B, no), oldest first -> whole
    window statistics; the ISI that crosses into each non-empty segment runs
    from the previous non-empty segment's last spike."""
    counts = torch.sum(segs["counts"], dim=0)
    sum_t, sum_t2 = counts * 0.0, counts * 0.0
    first = torch.full_like(counts, float("inf"))
    last = torch.full_like(counts, -1.0)
    n_isi = torch.sum(segs["n_isi"], dim=0)
    sum_isi = torch.sum(segs["sum_isi"], dim=0)
    sum_isi2 = torch.sum(segs["sum_isi2"], dim=0)
    bursts = torch.sum(segs["bursts"], dim=0)
    carry_last = torch.full_like(counts, -1.0)
    for k in range(segs["counts"].shape[0]):
        off = float(k * seg_len)
        ck = segs["counts"][k]
        has = ck > 0
        fk = segs["first"][k] + off
        lk = segs["last"][k]
        sum_t = sum_t + segs["sum_t"][k] + off * ck
        sum_t2 = sum_t2 + segs["sum_t2"][k] + 2.0 * off * segs["sum_t"][k] + off * off * ck
        first = torch.minimum(first, torch.where(has, fk, float("inf")))
        last = torch.maximum(last, torch.where(has, lk + off, -1.0))
        cross = has & (carry_last >= 0.0)
        isi = torch.where(cross, fk - carry_last, 0.0)
        n_isi = n_isi + cross.float()
        sum_isi = sum_isi + isi
        sum_isi2 = sum_isi2 + isi * isi
        bursts = bursts + (cross & (isi <= burst_isi_max)).float()
        carry_last = torch.where(has, lk + off, carry_last)
    return dict(counts=counts, sum_t=sum_t, sum_t2=sum_t2, first=first, last=last,
                n_isi=n_isi, sum_isi=sum_isi, sum_isi2=sum_isi2, bursts=bursts)


def features(stats: Dict[str, torch.Tensor], keys) -> torch.Tensor:
    """Per output neuron feature vectors, concatenated in `keys` order;
    entries that would divide by zero for a silent neuron are 0."""
    counts, n_isi = stats["counts"], stats["n_isi"]
    fired, has_isi = counts > 0, n_isi > 0
    safe_counts = torch.clamp(counts, min=1.0)
    safe_n_isi = torch.clamp(n_isi, min=1.0)
    mean_isi = stats["sum_isi"] / safe_n_isi
    if "win_counts" in stats:
        win = stats["win_counts"]
        win_mean = torch.mean(win, dim=-1)
        win_var = torch.mean(win * win, dim=-1) - win_mean * win_mean
    else:
        nw = stats["n_win_used"]
        win_mean = stats["win_sum"] / nw
        win_var = stats["win_sum2"] / nw - win_mean * win_mean
    derived = {
        "spike_counts": counts,
        "spike_variances": torch.where(fired, torch.clamp(win_var, min=0.0), 0.0),
        "mean_spike_times": torch.where(fired, stats["sum_t"] / safe_counts, 0.0),
        "first_spike_times": torch.where(fired, stats["first"], 0.0),
        "last_spike_times": torch.where(fired, stats["last"], 0.0),
        "mean_isi": torch.where(has_isi, mean_isi, 0.0),
        "isi_variances": torch.where(
            has_isi, torch.clamp(stats["sum_isi2"] / safe_n_isi - mean_isi * mean_isi, min=0.0),
            0.0),
        "burst_counts": stats["bursts"],
    }
    return torch.cat([derived[k] for k in keys], dim=-1)

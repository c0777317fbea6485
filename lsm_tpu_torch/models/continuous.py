"""Continuous-mode streaming KWS with state carried across hops
(port of lsm_tpu/models/continuous.py, both frontends, dense or
block-sparse reservoir, one device or the ranks of a mesh).

Every piece of sequential state persists across chunk boundaries, so a hop
of `chunk_len` samples costs only the new work:

  - gammatone cascade: the block-IIR scan continues from its carried
    (B, 8, C) state (kernel B3, bit-exact continuation), plus a
    (w_per - h_per)-sub-block energy tail for the windows that straddle
    the chunk boundary;
  - mel: one STFT frame per 160-sample hop from a carried
    (n_fft - hop, B, 1) raw-audio tail, with the batch path's window,
    filterbank and dB (power_to_db's ref = max subtraction cancels in the
    normalization but for the top_db floor, which the running peak
    applies); its IIR leaf is the zero-size (B, 0, C);
  - dB normalization: a causal running peak/floor with linear-in-dB decay
    and chunk-level lookahead, in place of the batch path's per-window
    min-max (the mode's main approximation);
  - hysteresis trigger state: carried exactly;
  - LIF reservoir: membrane, refractory and last-spike state carried
    (kernel B4 for a dense reservoir, B6 for a block-sparse one); the
    chunk's output spikes reduce to a segment summary;
  - window statistics: a ring of window/hop segment summaries and a ring
    of rate-window counts, pushed and folded into the window features per
    hop in one launch of the fold kernel on the card (`csrc/fold.cu`,
    `ops/kernels/fold.py`; on the CPU its plain twin,
    `reservoir.fold_segment_stats` and `features_from_stats`).

The serving surface is lsm_tpu's: step, step_compact, step_active,
stream, steps_fused, reset, snapshot / restore and extract_streams /
install_streams (the unit io/serving_state.py saves and migrates).

With `mesh=`, every state leaf holds this rank's streams along its stream
axis (`serving_state.stream_axis`) and the rank's kernels run on them;
outputs, snapshots and extracted rows are gathered to all n_streams on
every rank (models/streaming.py's module docstring has the contract).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Union

import numpy as np
import torch

from lsm_tpu_torch.config import FEATURE_SETS, FrontendConfig
from lsm_tpu_torch.models import reservoir as res
from lsm_tpu_torch.models.diagnostics import ServingDiagnosticsReport, serving_report
from lsm_tpu_torch.models.sparse import SparseReservoir
from lsm_tpu_torch.models.streaming import (
    bind_mesh, compact_output_device, decode_pcm_device, expand_active_rows, extract_rows,
    gather_streams, install_rows, local_slice, np_dtype, place_chunk, prepare_active_rows,
    stream_pipelined, swap_readout_on, unpack_compact_output, validate_stream_idx,
)
from lsm_tpu_torch.ops import gammatone as gt
from lsm_tpu_torch.ops import mel, stft
from lsm_tpu_torch.ops.hysteresis import hysteresis_encode_step
from lsm_tpu_torch.ops.kernels import fold as kfold
from lsm_tpu_torch.ops.kernels.lif import SEG_KEYS
from lsm_tpu_torch.parallel.mesh import Mesh
from lsm_tpu_torch.readout import logistic, scaler
from lsm_tpu_torch.utils.profiling import span

_LOG10 = 2.302585092994046


@dataclasses.dataclass
class ContinuousState:
    """All cross-chunk stream state. Batch axis first except `tail` and
    `segs` (ring-major like what they cache)."""

    iir: torch.Tensor        # (B, 8, C) f32 gammatone cascade state
                             #   (mel: (B, 0, C), no IIR state)
    tail: torch.Tensor       # gammatone: (w_per - h_per, B, C) f32 straddling
                             #   energies; mel: (n_fft - hop, B, 1) raw audio
    hyst: torch.Tensor       # (B, n_thr, C) bool Schmitt trigger state
    norm_hi: torch.Tensor    # (B,) f32 running peak dB
    norm_lo: torch.Tensor    # (B,) f32 running floor dB
    v: torch.Tensor          # (B, n_state) f32 membrane
    refrac: torch.Tensor     # (B, n_state) int32
    s_prev: torch.Tensor     # (B, n_state) f32 last step's spike vector
    segs: Dict[str, torch.Tensor]   # SEG_KEYS -> (n_ring, B, no); ring[0] oldest
    win_ring: torch.Tensor   # (B, no, n_win) f32 rate-window counts ring


# The value of each leaf in a fresh stream: "no observation yet".
_INIT = dict(iir=0.0, tail=0.0, hyst=False, norm_hi=-1e30, norm_lo=1e30,
             v=0.0, refrac=0, s_prev=0.0, win_ring=0.0)
_SEG_INIT = dict(first=float("inf"), last=-1.0)


class ContinuousKWS:
    """Stateful continuous keyword spotter over B parallel streams.

    `reservoir` is the port's dense `Reservoir` or block-sparse
    `SparseReservoir`, `readout` a `LogisticReadout` and `scaler_state` a
    `Scaler`. The carried LIF state is (n_streams, n_state): N_pad for a
    dense reservoir, n_neurons (a multiple of 128) for a sparse one. The
    engine runs on the reservoir's device (the card, or the CPU for a CPU
    reservoir) and moves the readout and scaler there. `chunk_len` must be
    a multiple of the featurizer hop (160 samples at 16 kHz) and divide the
    1 s window; `norm_decay_db_per_bin`
    is the causal normalization's peak/floor decay. The first ~1 s of a
    cold stream is warm-up: bins before its first loud event normalize
    against a noise-level peak, so readouts are calibrated in the
    carried-state condition (`fit_continuous_readout`). With `mesh=`, the
    state holds this rank's streams and chunks carry them (module
    docstring).
    """

    def __init__(
        self,
        reservoir: Union[res.Reservoir, SparseReservoir],
        readout: logistic.LogisticReadout,
        scaler_state: scaler.Scaler,
        fcfg: FrontendConfig,
        feature_set: str = "original",
        n_streams: int = 1,
        chunk_len: int = 1600,
        norm_decay_db_per_bin: float = 0.1,
        mesh: Optional[Mesh] = None,
    ):
        if fcfg.filterbank not in ("gammatone", "mel"):
            raise ValueError(f"unknown filterbank {fcfg.filterbank!r}")
        is_mel = fcfg.filterbank == "mel"
        if not isinstance(reservoir, (res.Reservoir, SparseReservoir)):
            raise TypeError(
                f"unsupported reservoir {type(reservoir).__name__}: the engine "
                "runs the port's Reservoir or SparseReservoir (lsm_tpu_torch.convert "
                "carries lsm_tpu's parameters across)"
            )
        if is_mel:
            # One STFT frame per hop; frames end flush with the chunk, so a
            # frame starts up to n_fft - hop samples before it.
            if fcfg.num_samples % fcfg.time_bins:
                raise ValueError(
                    f"num_samples {fcfg.num_samples} must be a multiple of "
                    f"time_bins {fcfg.time_bins}"
                )
            hop = fcfg.num_samples // fcfg.time_bins
            nwin = fcfg.n_fft
            if hop > nwin:
                raise ValueError(
                    f"mel hop ({hop} samples) must be <= n_fft ({nwin}): "
                    "with gaps between frames the carried audio tail has "
                    "no meaning"
                )
            g = hop
        else:
            hop_time = fcfg.num_samples / (fcfg.sample_rate * fcfg.time_bins)
            nwin, hop, _ = gt.gtgram_strides(
                fcfg.sample_rate, fcfg.gt_window_time, hop_time, fcfg.num_samples
            )
            if nwin < hop:
                raise ValueError(
                    f"gammatone window ({nwin} samples) must be >= the hop "
                    f"({hop}): with gaps between windows the energy-tail "
                    "carry has no meaning"
                )
            g = math.gcd(hop, nwin)
        if chunk_len % hop:
            raise ValueError(
                f"chunk_len {chunk_len} must be a multiple of the "
                f"featurizer hop ({hop} samples)"
            )
        n_thr = fcfg.n_thresholds
        n_cols = chunk_len // hop
        t_c = n_cols * n_thr                        # spike steps per chunk
        t_win = fcfg.time_bins * n_thr
        n_win = reservoir.n_rate_windows
        if t_win % t_c:
            raise ValueError(
                f"chunk spans {t_c} spike steps, which must divide the "
                f"{t_win}-step analysis window (chunk_len must divide "
                f"{fcfg.num_samples})"
            )
        if t_win % n_win:
            raise ValueError(
                f"n_rate_windows={n_win} must divide the {t_win}-step "
                "analysis window for the continuous rate-window ring "
                "(the batch path folds the remainder into the last window)"
            )
        win_len = max(1, t_win // n_win)
        if t_c % win_len:
            raise ValueError(
                f"chunk ({t_c} steps) must span whole rate windows "
                f"({win_len} steps; n_rate_windows={n_win})"
            )

        self.device = reservoir.w_in.device
        # Part of the serving-state identity, as in lsm_tpu, where it is
        # True only when the two-phase Pallas kernel runs: here kernel B3
        # runs on the card and its plain twin on the CPU, and the two agree
        # to rounding, not bits, so carried state from one must not
        # continue under the other. CPU snapshots of either package load
        # in the other. The mel branch runs no cascade: False, as in
        # lsm_tpu.
        self.gtgram_two_phase = self.device.type == "cuda" and not is_mel
        self._is_mel = is_mel
        self.reservoir = reservoir
        self._n_state = (reservoir.n_neurons if isinstance(reservoir, SparseReservoir)
                         else reservoir.w_rec.shape[0])
        self.readout = readout.to(self.device)
        self.scaler_state = scaler_state.to(self.device)
        self.fcfg = fcfg
        self.keys = tuple(FEATURE_SETS[feature_set])
        self.n_streams = int(n_streams)
        bind_mesh(self, mesh, "n_streams={n_streams} must be divisible by the mesh data "
                              "axis ({n_data})")
        self.chunk_len = int(chunk_len)
        self._decay = float(norm_decay_db_per_bin)
        self._g, self._nwin, self._n_cols = g, nwin, n_cols
        self._w_per, self._h_per = nwin // g, hop // g
        # Carried frontend state: gammatone keeps straddling sub-block
        # energies (w_per - h_per, B, C) and the (B, 8, C) cascade state;
        # mel keeps raw audio (n_fft - hop, B, 1) and no cascade state.
        self._tail = (nwin - hop) if is_mel else (self._w_per - self._h_per)
        self._tail_ch = 1 if is_mel else fcfg.n_filters
        self._iir_n = 0 if is_mel else 8
        if is_mel:
            fmax = fcfg.mel_fmax if fcfg.mel_fmax is not None else fcfg.sample_rate / 2.0
            self._mel_fb_t = mel.filterbank_on(
                fcfg.sample_rate, fcfg.n_fft, fcfg.n_filters, fcfg.mel_fmin, fmax, self.device
            ).t()                                           # (n_freqs, C)
            self._hann = stft.window_on(fcfg.n_fft, self.device)
        self._t_c, self._win_len = t_c, win_len
        self._n_ring = t_win // t_c
        self._n_new_win = t_c // win_len
        # (n_cols, 1): bin j of a chunk ages the carried peak/floor by j + 1.
        self._jj = torch.arange(n_cols, dtype=torch.float32, device=self.device)[:, None]
        self.state = self._init_state(self.n_local)

    # ---- the step, in three stages -----------------------------------

    def _normalize_encode(self, db: torch.Tensor, st: ContinuousState):
        """(n_cols, B, C) dB bins -> ((B, C', T_c) spikes, trigger state,
        peak, floor). Every bin normalizes against the whole chunk's
        extrema merged with the carried peak/floor aged by the bin's
        distance; then the batch path's floor at peak - top_db, min-max and
        degenerate-range rule, and the carried-state hysteresis encoder."""
        fcfg, d = self.fcfg, self._decay
        colmax = torch.amax(db, dim=-1)                       # (n_cols, B)
        colmin = torch.amin(db, dim=-1)
        hi = torch.maximum(torch.amax(colmax, dim=0, keepdim=True),
                           st.norm_hi[None, :] - d * (self._jj + 1.0))
        lo = torch.minimum(torch.amin(colmin, dim=0, keepdim=True),
                           st.norm_lo[None, :] + d * (self._jj + 1.0))
        floor = hi - fcfg.power_top_db
        lo_eff = torch.maximum(lo, floor)
        rng = hi - lo_eff
        x = torch.maximum(db, floor[..., None])
        norm = torch.where((rng < 1e-8)[..., None], 0.0,
                           (x - lo_eff[..., None]) / (rng + 1e-8)[..., None])
        spec = torch.clamp(norm, 0.0, 1.0).permute(1, 2, 0)  # (B, C, n_cols)
        spikes, hyst = hysteresis_encode_step(
            spec, st.hyst, fcfg.spike_thresholds, fcfg.hysteresis_gap
        )
        if fcfg.redundancy_factor > 1:
            spikes = torch.repeat_interleave(spikes, fcfg.redundancy_factor, dim=-2)
        return spikes, hyst, hi[-1], lo[-1]

    def _featurize(self, chunk: torch.Tensor, st: ContinuousState):
        """Decoded (B, chunk_len) f32 audio -> (spikes, iir, tail, hyst,
        norm_hi, norm_lo). Gammatone: window c sums sub-blocks [c*h_per,
        c*h_per + w_per) of [carried tail | this chunk's energies]."""
        if self._is_mel:
            return self._featurize_mel(chunk, st)
        fcfg = self.fcfg
        # B3 converts its state once a chunk: at the chunk's ends.
        iir, sub_e = gt.gtgram_chunk(chunk, st.iir, fcfg.sample_rate,
                                     fcfg.n_filters, fcfg.gt_f_min, self._g,
                                     conv_sub=self.chunk_len // self._g)
        all_e = torch.cat([st.tail, sub_e], dim=0)            # (tail + n_sub, B, C)
        h = self._h_per
        reach = (self._n_cols - 1) * h + 1
        win_e = all_e[0:reach:h]
        for j in range(1, self._w_per):
            win_e = win_e + all_e[j:j + reach:h]              # (n_cols, B, C)
        amp = torch.sqrt(win_e / self._nwin)
        db = 20.0 * torch.log(amp + 1e-9) / _LOG10
        spikes, hyst, hi, lo = self._normalize_encode(db, st)
        # Explicit start index: all_e[-0:] would keep the whole buffer.
        new_tail = all_e[all_e.shape[0] - self._tail:]
        return spikes, iir, new_tail, hyst, hi, lo

    def _featurize_mel(self, chunk: torch.Tensor, st: ContinuousState):
        """The mel branch: frame i covers [i*hop, i*hop + n_fft) of
        [carried audio tail | chunk], so the last frame ends flush with the
        chunk; the batch path's window, filterbank and dB, without the
        ref = max subtraction."""
        audio_tail = st.tail[:, :, 0].t()                     # (B, tail)
        concat = torch.cat([audio_tail, chunk], dim=-1)
        frames = concat.unfold(-1, self.fcfg.n_fft, self._g) * self._hann
        spec = torch.fft.rfft(frames, dim=-1)                 # (B, n_cols, n_freqs)
        power = spec.real ** 2 + spec.imag ** 2
        melp = torch.matmul(power, self._mel_fb_t)            # (B, n_cols, C)
        db = (10.0 * torch.log(torch.clamp_min(melp, 1e-10)) / _LOG10).transpose(0, 1)
        spikes, hyst, hi, lo = self._normalize_encode(db, st)
        # Explicit start index: concat[:, -0:] would keep the whole buffer.
        new_tail = concat[:, concat.shape[1] - self._tail:].t().unsqueeze(-1).contiguous()
        return spikes, st.iir, new_tail, hyst, hi, lo

    def _reservoir_chunk(self, spikes: torch.Tensor, st: ContinuousState):
        """(B, C', T_c) spikes + carried state -> (v, refrac, s_prev,
        segment summary, win_counts (B, n_new_win, no))."""
        return res.simulate_chunk(self.reservoir, spikes, st.v, st.refrac,
                                  st.s_prev, self._win_len, self._n_new_win)

    def _window_features(self, segs, win_ring) -> torch.Tensor:
        """The raw window features of the rings as they are."""
        return kfold.fold(segs, win_ring, self._t_c, self.reservoir.burst_isi_max, self.keys)[2]

    def _evaluate(self, st: ContinuousState, new_seg, win_new):
        """Push the chunk's summary into the rings, fold them (one launch of
        the fold kernel on the card) and apply the readout: (segs,
        win_ring, logits)."""
        segs, win_ring, feats = kfold.fold(st.segs, st.win_ring, self._t_c,
                                           self.reservoir.burst_isi_max, self.keys,
                                           new_seg, win_new)
        sc, ro = self.scaler_state, self.readout
        logits = (feats - sc.mean) / sc.scale @ ro.w + ro.b
        return segs, win_ring, logits

    def _step_device(self, chunk: torch.Tensor) -> torch.Tensor:
        """One hop on a device-resident wire chunk; advances the state and
        returns the (B, K) logits on the device (nothing synchronizes)."""
        st = self.state
        with span("lsm.kws.frontend"):
            spikes, iir, tail, hyst, hi, lo = self._featurize(decode_pcm_device(chunk), st)
        with span("lsm.kws.reservoir"):
            v, refrac, s_prev, new_seg, win_new = self._reservoir_chunk(spikes, st)
        with span("lsm.kws.readout"):
            segs, win_ring, logits = self._evaluate(st, new_seg, win_new)
        self.state = ContinuousState(
            iir=iir, tail=tail, hyst=hyst, norm_hi=hi, norm_lo=lo,
            v=v, refrac=refrac, s_prev=s_prev, segs=segs, win_ring=win_ring,
        )
        return logits

    def _place_chunk(self, chunk) -> torch.Tensor:
        """A host chunk through the ingest policy onto the engine's device;
        a tensor must already be a (n_streams, chunk_len) f32, int16 or
        uint8 tensor on that device."""
        with span("lsm.kws.ingest"):
            return place_chunk(self, chunk, fixed_len=True)

    # ---- public surface ------------------------------------------------

    @property
    def norm_decay_db_per_bin(self) -> float:
        """The causal normalization decay this engine was built with
        (bundles and serving-state files record it)."""
        return self._decay

    def step(self, chunk) -> np.ndarray:
        """Ingest one (n_streams, chunk_len) chunk (float samples in
        [-1, 1], int16 PCM or uint8 mu-law, host array or device tensor)
        and return the (n_streams, n_classes) logits on the host."""
        with span("lsm.kws.step"):
            logits = self._step_device(self._place_chunk(chunk))
            with span("lsm.kws.egress"):
                return gather_streams(self, logits).cpu().numpy()

    def step_compact(self, chunk):
        """step() with the compact decision output
        (streaming.compact_output_device): (preds int32 (B,), margin f32
        (B,)), 4 bytes a stream off the device; the same state advance as
        step(), preds equal to step(chunk).argmax(-1)."""
        with span("lsm.kws.step"):
            logits = self._step_device(self._place_chunk(chunk))
            with span("lsm.kws.egress"):
                return unpack_compact_output(gather_streams(self, compact_output_device(logits)))

    def step_active(self, rows, active_idx, compact: bool = False):
        """step() with only the active streams' audio on the wire: `rows`
        (k, chunk_len) in any ingest wire format for the k slots
        `active_idx`. Silent streams advance on wire silence synthesized on
        the device (streaming.wire_silence), so the logits and every
        stream's carried state are bit-equal to step() on the full chunk
        with silence in the inactive rows. compact=True returns (preds,
        margin) as step_compact does. On a mesh every rank passes the same
        global rows and slots."""
        with span("lsm.kws.step"):
            with span("lsm.kws.ingest"):
                rows_d, idx_d = prepare_active_rows(self, rows, active_idx,
                                                    chunk_len=self.chunk_len)
                chunk = expand_active_rows(rows_d, idx_d, self.n_local)
            out = self._step_device(chunk)
            with span("lsm.kws.egress"):
                if compact:
                    return unpack_compact_output(gather_streams(self, compact_output_device(out)))
                return gather_streams(self, out).cpu().numpy()

    def stream(self, chunks, depth: int = 2):
        """Pipelined serving loop: yields per-chunk logits, bit-equal to
        serial step() calls (streaming.stream_pipelined)."""
        return stream_pipelined(self, chunks, depth=depth)

    def steps_fused(self, chunk, k: int) -> float:
        """k consecutive step() calls on the same chunk, with one host
        transfer at the end: the last hop's logit sum. The state advances
        exactly as k step() calls on that chunk."""
        dev = self._place_chunk(chunk)
        for _ in range(int(k)):
            out = self._step_device(dev)
        return float(torch.sum(gather_streams(self, out), dtype=torch.float32))

    def predict(self, chunk) -> np.ndarray:
        return np.argmax(self.step(chunk), axis=-1)

    def features(self) -> np.ndarray:
        """Raw (unscaled) window features of the current trailing window,
        the vector the last step() pushed through the readout:
        (n_streams, len(keys) * n_outputs)."""
        return gather_streams(
            self, self._window_features(self.state.segs, self.state.win_ring)).cpu().numpy()

    def diagnostics(self, stream_idx=None) -> ServingDiagnosticsReport:
        """Reservoir health on live traffic from the output neurons' window
        spike counts the segment ring already carries; `stream_idx`
        selects the streams the verdict averages over (None = all). On a
        mesh a collective that gives every rank the same report."""
        counts = torch.sum(self.state.segs["counts"], dim=0)          # (B, no)
        active = torch.sum(counts > 0, dim=1).to(torch.int32)
        total = torch.sum(counts, dim=1)
        return serving_report(gather_streams(self, active).cpu().numpy(),
                              gather_streams(self, total).cpu().numpy(),
                              self.reservoir.n_outputs, "output", stream_idx)

    def swap_readout(self, readout, scaler_state=None) -> None:
        """Hot readout cutover without touching stream state
        (streaming.swap_readout_on)."""
        swap_readout_on(self, readout, scaler_state)

    def reset(self, stream_idx=None) -> None:
        """Re-initialize stream state: all streams (None), or the slots
        named by an int, a sequence of ints or a (n_streams,) bool mask
        (global; each rank resets the slots it holds); every leaf of just
        those slots returns to its fresh value and the other streams are
        untouched."""
        if stream_idx is None:
            self.state = self._init_state(self.n_local)
            return
        idx = np.asarray(stream_idx)
        if idx.dtype == np.bool_:
            if idx.shape != (self.n_streams,):
                raise ValueError(
                    f"bool mask must have shape ({self.n_streams},), got {idx.shape}"
                )
            mask = idx
        else:
            mask = np.zeros((self.n_streams,), np.bool_)
            mask[idx] = True
        m = torch.as_tensor(mask[self.rows], device=self.device)

        def sel(cur, init_val, axis):
            shape = [1] * cur.dim()
            shape[axis] = m.shape[0]
            fresh = torch.full((), init_val, dtype=cur.dtype, device=self.device)
            return torch.where(m.view(shape), fresh, cur)

        st = self.state
        leaves = {k: sel(getattr(st, k), v, 1 if k == "tail" else 0)
                  for k, v in _INIT.items()}
        segs = {k: sel(st.segs[k], _SEG_INIT.get(k, 0.0), 1) for k in SEG_KEYS}
        self.state = ContinuousState(segs=segs, **leaves)

    # ---- state as leaves: snapshots and migration ------------------------

    def _state_leaves(self) -> Dict[str, torch.Tensor]:
        """Flat name -> tensor view of the state, segment rings keyed
        'seg:<stat>': the leaves of a snapshot. Stream axis of each:
        serving_state.stream_axis."""
        st = self.state
        leaves = {k: getattr(st, k) for k in _INIT}
        leaves.update({f"seg:{k}": v for k, v in st.segs.items()})
        return leaves

    def _from_leaves(self, leaves: Dict[str, torch.Tensor]) -> ContinuousState:
        return ContinuousState(segs={k: leaves[f"seg:{k}"] for k in SEG_KEYS},
                               **{k: leaves[k] for k in _INIT})

    def snapshot(self) -> Dict[str, np.ndarray]:
        """Host copy of every state leaf (lsm_tpu's leaves, shapes, dtypes
        and axes), all n_streams on every rank (a collective on a mesh).
        Restoring it into a fresh engine with the same weights continues
        every stream bit-exactly, warm-up included (io/serving_state.py is
        the file format and its validation)."""
        from lsm_tpu_torch.io.serving_state import stream_axis

        return {k: gather_streams(self, v, stream_axis(k)).to("cpu", copy=True).numpy()
                for k, v in self._state_leaves().items()}

    def restore(self, snap: dict) -> None:
        """Inverse of snapshot(): install a saved state (full arrays, the
        same on every rank; each takes its streams). Every leaf is checked
        against this engine's geometry first, so a snapshot taken with
        another stream count, frontend, reservoir or chunking fails loudly
        and leaves the state as it was."""
        from lsm_tpu_torch.io.serving_state import stream_axis

        extra = {k for k in snap if k.startswith("seg:") and k[4:] not in SEG_KEYS}
        if extra:
            raise ValueError(
                f"snapshot has segment stats {sorted(extra)} this engine "
                "does not track (different feature set)"
            )
        new = {}
        for key, ref in self._state_leaves().items():
            if key not in snap:
                raise ValueError(
                    f"snapshot is missing state leaf {key!r} — not a "
                    "ContinuousKWS snapshot, or one from an incompatible build"
                )
            a = np.asarray(snap[key])
            ax = stream_axis(key)
            shape = tuple(self.n_streams if d == ax else n for d, n in enumerate(ref.shape))
            want = (shape, np_dtype(ref))
            if (a.shape, a.dtype) != want:
                raise ValueError(
                    f"snapshot leaf {key!r} is {a.dtype}{a.shape}; this "
                    f"engine needs {want[1]}{want[0]} — the snapshot was "
                    "taken with a different stream count, frontend, "
                    "reservoir, or chunk geometry"
                )
            new[key] = torch.tensor(local_slice(a, self.rows, ax), device=self.device)
        self.state = self._from_leaves(new)

    def extract_streams(self, stream_idx) -> Dict[str, np.ndarray]:
        """snapshot() restricted to the named stream slots: each leaf's
        rows are gathered on the device, so only they leave it. The unit
        serving_state.migrate_streams moves; on a mesh a collective."""
        from lsm_tpu_torch.io.serving_state import stream_axis

        idx = validate_stream_idx(stream_idx, self.n_streams, "extract_streams")
        return extract_rows(self, {k: (v, stream_axis(k)) for k, v in self._state_leaves().items()},
                            idx.astype(np.int64))

    def install_streams(self, stream_idx, rows: dict) -> None:
        """Inverse of extract_streams: scatter donor stream state into the
        named slots (other slots untouched). `rows` carries one row per
        index along each leaf's stream axis, the leaves and dtypes of
        extract_streams; all are checked before any state changes. Each
        rank writes the slots it holds."""
        from lsm_tpu_torch.io.serving_state import stream_axis

        idx = validate_stream_idx(stream_idx, self.n_streams, "install_streams", unique=True)
        ref = self._state_leaves()
        missing = set(ref) - set(rows)
        if missing:
            raise ValueError(f"donor rows are missing state leaves {sorted(missing)}")
        clean = {}
        for k, leaf in ref.items():
            ax = stream_axis(k)
            want = tuple(idx.shape[0] if d == ax else s for d, s in enumerate(leaf.shape))
            r = np.asarray(rows[k])
            if r.shape != want or r.dtype != np_dtype(leaf):
                raise ValueError(
                    f"donor leaf {k!r} is {r.dtype}{r.shape}; this engine "
                    f"needs {np_dtype(leaf)}{want} — the donor engine "
                    "has a different geometry"
                )
            clean[k] = r
        self.state = self._from_leaves(install_rows(
            self, {k: (leaf, stream_axis(k)) for k, leaf in ref.items()}, idx.astype(np.int64),
            clean))

    def _init_state(self, B: int) -> ContinuousState:
        C = self.fcfg.n_filters
        n_state = self._n_state
        no = self.reservoir.n_outputs
        shapes = dict(
            iir=(B, self._iir_n, C), tail=(self._tail, B, self._tail_ch),
            hyst=(B, self.fcfg.n_thresholds, C), norm_hi=(B,), norm_lo=(B,), v=(B, n_state),
            refrac=(B, n_state), s_prev=(B, n_state), win_ring=(B, no, self.reservoir.n_rate_windows),
        )
        dtypes = dict(hyst=torch.bool, refrac=torch.int32)
        leaves = {
            # norm_hi/norm_lo start at -1e30/+1e30: they lose every max/min
            # against real data, so the first chunk normalizes on observed
            # bins alone (a -180 dB silence init saturates the encoder).
            k: torch.full(shapes[k], _INIT[k], dtype=dtypes.get(k, torch.float32),
                          device=self.device)
            for k in _INIT
        }
        segs = {
            k: torch.full((self._n_ring, B, no), _SEG_INIT.get(k, 0.0),
                          dtype=torch.float32, device=self.device)
            for k in SEG_KEYS
        }
        return ContinuousState(segs=segs, **leaves)


def fit_continuous_readout(
    reservoir: Union[res.Reservoir, SparseReservoir],
    fcfg: FrontendConfig,
    audio: np.ndarray,            # (N, num_samples) training utterances
    labels: np.ndarray,           # (N,) int
    num_classes: int,
    feature_set: str = "original",
    chunk_len: int = 1600,
    norm_decay_db_per_bin: float = 0.1,
    mesh: Optional[Mesh] = None,
    l2_c: float = 1.0,
    max_iter: int = 1000,
    tol: float = 1e-4,
):
    """Calibrate a scaler and logistic readout on continuous-mode features
    in the carried-state condition: every utterance streams after another
    one (a fixed-seed permutation, rng 12345, not a roll: corpora are often
    class-blocked), with no reset, and the window features are read at its
    last chunk, on the reservoir's device. With `mesh=` the utterances
    stream through the mesh engine (N must divide over the data axis),
    each rank feeding its rows, and every rank fits on the gathered
    features. Returns (LogisticReadout, Scaler) for ContinuousKWS."""
    n = audio.shape[0]
    n_chunks = fcfg.num_samples // chunk_len
    d = len(FEATURE_SETS[feature_set]) * reservoir.n_outputs
    kws = ContinuousKWS(
        reservoir,
        logistic.LogisticReadout(torch.zeros(d, num_classes), torch.zeros(num_classes)),
        scaler.Scaler(torch.zeros(d), torch.ones(d)),
        fcfg, feature_set, n_streams=n, chunk_len=chunk_len,
        norm_decay_db_per_bin=norm_decay_db_per_bin, mesh=mesh,
    )
    prev = audio[np.random.default_rng(12345).permutation(n)]
    for src in (prev[kws.rows], audio[kws.rows]):
        for c in range(n_chunks):
            kws._step_device(kws._place_chunk(src[:, c * chunk_len:(c + 1) * chunk_len]))
    feats = gather_streams(kws, kws._window_features(kws.state.segs, kws.state.win_ring))
    st = scaler.fit_scaler(feats)
    readout, _ = logistic.fit_logistic(
        scaler.transform(st, feats),
        torch.as_tensor(np.asarray(labels), dtype=torch.int64).to(kws.device),
        num_classes=num_classes, l2_c=l2_c, max_iter=max_iter, tol=tol,
    )
    return readout, st

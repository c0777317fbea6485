"""The mel spectrogram (models/frontend.py's mel branch: ops/stft.py's
framing, window, rFFT and power, ops/mel.py's filterbank product and
ops/db.py's power_to_db), whatever implements it: its least work per
utterance, all of it float32 work against the float32 peak. Per frame the
window product (n_fft multiplies), the real FFT at 2.5 n_fft log2 n_fft
flops, the power (3 flops a bin) and 2 flops per nonzero filterbank tap
(not the dense product, so that no implementation can read over 100 %);
per (filter, frame) the dB at 5 flops (the utterance's max, a log, a
multiply-add, the floor). Bytes: the audio read once and the dB
spectrogram written once. Its time is the device time under the program's
`lsm.frontend.spectrogram` span (metrics/melspec_roofline.py), so it has
no kernel names of its own."""

import math

KERNELS = ()


def work(run: dict):
    sh = run["shape"]
    if run["cell_kind"] != "batch" or sh.get("filterbank") != "mel":
        return None
    u, frames, n = run["utterances"], sh["frames"], sh["n_fft"]
    bins, filters = n // 2 + 1, sh["channels"]
    per_frame = n + 2.5 * n * math.log2(n) + 3.0 * bins + 2.0 * sh["mel_taps"] + 5.0 * filters
    return {"tc": 0.0, "f32": u * frames * per_frame,
            "bytes": u * (run["samples"] + filters * frames) * 4.0}

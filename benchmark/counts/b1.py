"""B1 (csrc/gtgram.cu, from a zero state): the batch path's gammatone
energies. Slaney's four-section cascade per (utterance, channel, sample):
each section one FMA for the output, two for the first state, one
multiply for the second, and one FMA for the energy, 17 float32
instructions of 2 flops each, against the float32 peak. Bytes: the padded
wave read once, the sub-block energies written once, the coefficients once
a step."""

KERNELS = ("gtgram_kernel<false>",)


def work(run: dict):
    if run["cell_kind"] != "batch":
        return None
    u, c, s = run["utterances"], run["shape"]["channels"], run["samples"]
    return {"tc": 0.0, "f32": 2.0 * 17 * u * c * s,
            "bytes": u * s * 4.0 + run["n_sub"] * u * c * 4.0 + run["steps"] * c * 11 * 4.0}

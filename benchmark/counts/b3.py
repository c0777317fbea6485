"""B3 (csrc/gtgram.cu, from the carried state): the serving hop's
gammatone energies. The cascade's 2 x 17 float32 flops per (stream,
channel, sample), against the float32 peak. Bytes: the decoded chunk read
once, the (B, 8, C) state read and written, the sub-block energies written,
the coefficients once a hop."""

KERNELS = ("gtgram_kernel<true>",)


def work(run: dict):
    if run["cell_kind"] != "serve":
        return None
    b, h, c, n = run["streams"], run["hops"], run["channels"], run["chunk_len"]
    per_hop = b * n * 4.0 + 2 * b * 8 * c * 4.0 + run["n_sub"] * b * c * 4.0 + c * 11 * 4.0
    return {"tc": 0.0, "f32": 2.0 * 17 * b * c * n * h, "bytes": h * per_hop}

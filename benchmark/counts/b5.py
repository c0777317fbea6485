"""B5 (csrc/sparse_lif.cu, whole utterances from a zero state): the
block-sparse reservoir with its statistics, by counts/b6.py's rules. One
add per true recurrent edge of a fired source neuron (its out-degree,
counted from the benchmark's weights) and per input edge of a fired
channel, against the bf16 tensor-core peak; the membrane update's 2
float32 flops per (utterance, step, neuron) against the float32 peak.
Fired rows come from the plain reference's spikes on the checked steps'
inputs, per utterance. Bytes: the spikes read once, the weight blocks and
their source table once a step, the statistics and the all-neuron counts
written once. Every device function of a call counts as its time."""

KERNELS = ("block_step_kernel", "transpose_blocks_kernel", "pack_input_kernel",
           "load_state_kernel", "store_state_kernel", "stats_kernel")


def work(run: dict):
    sh = run["shape"]
    if run["cell_kind"] != "batch" or "out_degree" not in sh:
        return None
    u, t, n = run["utterances"], sh["steps"], sh["neurons"]
    adds = (run["rec_rows_per_utt"] * sh["out_degree"]
            + run["in_rows_per_utt"] * sh["in_fanout"]) * u
    return {"tc": adds, "f32": 2.0 * u * t * n,
            "bytes": u * sh["in_channels"] * t + run["steps"] * sh["weight_bytes"]
            + u * (11 * sh["outputs"] + sh["width"]) * 4.0}

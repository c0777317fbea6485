"""B6 (csrc/sparse_lif.cu, one serving hop from the carried state): the
block-sparse reservoir over a chunk of steps. One add per true recurrent
edge of a fired source neuron (its out-degree, counted from the
benchmark's weights) and per input edge of a fired channel, against the
bf16 tensor-core peak; the membrane update's 2 float32 flops per (stream,
step, neuron) against the float32 peak. Fired rows come from the plain
reference's spikes on the checked hops' inputs, per stream-hop. Bytes: the
spikes, the weight blocks and their source table once a hop, the carried
v, refractory counter and spike vector read and written, the segment
summary and window counts written. All six device functions of a call
count as its time."""

KERNELS = ("block_step_kernel", "transpose_blocks_kernel", "pack_input_kernel",
           "load_state_kernel", "store_state_kernel", "stats_kernel")


def work(run: dict):
    sh = run["shape"]
    if run["cell_kind"] != "serve" or "out_degree" not in sh:
        return None
    b, h, t, n = run["streams"], run["hops"], run["t_c"], sh["neurons"]
    adds = (run["rec_rows_per_stream_hop"] * sh["out_degree"]
            + run["in_rows_per_stream_hop"] * sh["in_fanout"]) * b * h
    per_hop = (b * sh["in_channels"] * t + sh["weight_bytes"] + 2 * b * sh["width"] * 12.0
               + b * (9 + run["n_new_win"]) * sh["outputs"] * 4.0)
    return {"tc": adds, "f32": 2.0 * b * t * n * h, "bytes": h * per_hop}

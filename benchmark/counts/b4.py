"""B4 (csrc/lif.cu, one serving hop from the carried state): the dense
reservoir over a chunk of steps. One add per (fired source row, neuron)
against the bf16 tensor-core peak (a source row: a carried or fired
recurrent neuron that drives a next step, or a fired input channel), and
the membrane update's 2 float32 flops per (stream, step, neuron) against
the float32 peak. Fired rows come from the plain reference's spikes on the
checked hops' inputs, per stream-hop. Bytes: the spikes, the weights once
a hop, the carried v, refractory counter and spike vector read and
written, the segment summary and window counts written."""

KERNELS = ("lif_kernel<true", "lif_cluster_kernel<true")


def work(run: dict):
    sh = run["shape"]
    if run["cell_kind"] != "serve" or "out_degree" in sh:
        return None
    b, h, t, n = run["streams"], run["hops"], run["t_c"], sh["neurons"]
    rows = (run["rec_rows_per_stream_hop"] + run["in_rows_per_stream_hop"]) * b * h
    per_hop = (b * sh["in_channels"] * t + sh["weight_bytes"] + 2 * b * sh["width"] * 12.0
               + b * (9 + run["n_new_win"]) * sh["outputs"] * 4.0)
    return {"tc": rows * n, "f32": 2.0 * b * t * n * h, "bytes": h * per_hop}

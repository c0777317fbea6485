"""B2 (csrc/lif.cu, whole utterances): the dense reservoir with its
statistics. The drive is one add per (fired source row, neuron), where a
source row is a recurrent neuron that fired at a step that drives another
or an input channel that fired; its weights are bf16, so these adds are
held against the bf16 tensor-core peak. The membrane update is 2 float32
flops per (utterance, step, neuron), against the float32 peak. Fired rows
come from the plain reference's spikes on the run's inputs. Bytes: the
spikes read once, the weights once a step, the statistics and the
all-neuron counts written once."""

KERNELS = ("lif_kernel<false", "lif_cluster_kernel<false")


def work(run: dict):
    sh = run["shape"]
    if run["cell_kind"] != "batch" or "out_degree" in sh:
        return None
    u, t, n = run["utterances"], sh["steps"], sh["neurons"]
    rows = (run["rec_rows_per_utt"] + run["in_rows_per_utt"]) * u
    return {"tc": rows * n, "f32": 2.0 * u * t * n,
            "bytes": u * sh["in_channels"] * t + run["steps"] * sh["weight_bytes"]
            + u * (11 * sh["outputs"] + sh["width"]) * 4.0}

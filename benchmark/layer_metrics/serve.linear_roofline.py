"""The speech encoder's linear maps: the least time a call of every bf16
matmul that runs as a cuBLAS GEMM (counts/speech_encoder.py's ``gemms``: the
transformer layers' Q, K, V, output and feed-forward maps, the feature
projection, the glue's Linear and the resizes done as matmuls) at the cell's
shape, over the device time a call of those GEMMs' rows, in %. The rows are
picked by the names the card prints for cuBLAS's bf16 GEMMs (``nvjet_*``,
and its CUTLASS and ``xmma`` GEMMs of bf16), which leaves out cuDNN's
convolutions and the positional convolution's complex float32 GEMM. None
where no such rows ran or the configuration has no speech encoder."""

import re

from benchmark import counts
from benchmark.counts import speech_encoder

KERNEL = re.compile(r"^nvjet_|xmma_gemm_bf16|tensorop_bf16_s\d+gemm")


def read(ctx):
    model = ctx["config"]["model"]
    calls = ctx["work"].get("calls", 0)
    seconds = sum(s for name, (s, _) in ctx["rows"].items() if KERNEL.search(name))
    if "hidden_size" not in model or seconds <= 0 or not calls:
        return None
    flops, nbytes = speech_encoder.linear_count(model, ctx["work"]["batch"],
                                                ctx["work"]["samples"],
                                                2 if model["precision"] == "bf16" else 4)
    return 100.0 * counts.bound_s(flops, nbytes) / (seconds / calls)

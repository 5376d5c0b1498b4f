"""stream_ms.frame: the streamed tier's traversal wrappers of
kernels/stream.py as its tracers call them (trace_tiles_streamed:
closest_stream_kernel, one a closest-hit pass; any_hit_tiles_streamed:
anyhit_stream_kernel, one a light's shadow pass), ms a frame summed over
them, mean over the window's frames."""
SPANS = {"kernels.stream_closest": "tracer_torch.kernels.stream:trace_tiles_streamed",
         "kernels.stream_anyhit": "tracer_torch.kernels.stream:any_hit_tiles_streamed"}


def read(t):
    parts = [t.per_unit_ms(n) for n in SPANS]
    return None if None in parts else sum(parts)

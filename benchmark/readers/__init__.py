"""One reader a per-layer metric, found by the metric's name: `read(trace)`
returns the metric's value from a `trace.Trace`, or None where the trace
holds nothing for it to read."""

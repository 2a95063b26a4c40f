"""Tools that drive the port end to end (the counterparts of the JAX
package's `tools/` scripts and `bench_serving.py`): `serve_13b_w8a16`,
GPT-3 13B weight-only-int8 greedy decode on one card; `bench_serving`,
the serving bench's offered-load sweep, single-stream baseline,
shared-prefix and tracing-cost legs; `healthwatch` and `memwatch`, the
offline replays of the health rules over a metrics JSONL."""

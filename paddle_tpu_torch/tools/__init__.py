"""Recipes that drive the port end to end (the counterparts of the JAX
package's `tools/` scripts that run a model): `serve_13b_w8a16`, GPT-3
13B weight-only-int8 greedy decode on one card."""

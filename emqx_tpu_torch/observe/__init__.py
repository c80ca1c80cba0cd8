"""Observability: counters, latency histograms, the degradation ledger,
span collection, and the kernel-plane fold of the routing step."""

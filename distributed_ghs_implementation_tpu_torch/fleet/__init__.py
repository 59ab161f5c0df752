"""The fleet's wire format: length-prefixed JSON frames and B-frames
(``framing``). The router, workers and transports of the JAX package's
``fleet/`` are not ported (ROADMAP queue 1)."""

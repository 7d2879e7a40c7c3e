"""The benchmark's yardstick: what no runner, reference or reader of one
cell owns."""

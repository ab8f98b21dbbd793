"""The benchmark's own pieces: the spec files found by name, the card, the
counts, the seeded weights and inputs, the trace, the checks, the guard."""

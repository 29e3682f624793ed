"""Core PLAID engine: codec, index, scoring, the batched pipeline."""

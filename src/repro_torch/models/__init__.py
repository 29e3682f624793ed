"""The ColBERT encoder: a dense transformer backbone and its projection."""

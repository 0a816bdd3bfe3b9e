"""Data substrate: tokenizer and synthetic QA corpus (numpy-only copies of
``repro.data``'s modules)."""

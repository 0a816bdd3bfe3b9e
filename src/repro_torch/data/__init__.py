"""Data substrate: tokenizer, synthetic QA corpus and MusicGen's codebook
delay pattern (numpy-only copies of ``repro.data``'s modules)."""

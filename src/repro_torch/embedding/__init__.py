"""Embedding generation (paper §2.2): the hash n-gram embedder."""

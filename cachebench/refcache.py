"""The plain reference of the cache path: what every served request should
have been answered, worked out again from the benchmark's own inputs.

Frozen copies of the port's hash embedder and hash tokenizer
(``repro_torch/embedding/hash_embedder.py``, ``data/tokenizer.py``), and a
slab of f32 unit keys with a ring insert, replayed batch by batch in the
order the server formed them. A lookup in a batch sees the slab as it was
before the batch (the step inserts the batch's misses after the search),
takes the best cosine (ties to the lowest slot) and hits at score >= tau.
The misses go into the ring in row order. The answers follow the engine's
tokenizer round trips: a cached answer is stored as ``value_len`` tokens
and read back; a generated one is the model's tokens read by the
backend's tokenizer, then stored and read back by the engine's.

The slab never expires in a run (the engine's clock does not move while
it serves), and the batches come from the program's own record of which
requests shared one. The answers a miss generated are the program's
output: the reference reads them to say what a later hit on that entry
must answer, and the model check (``refmodel``) judges the tokens.

With ``control=True`` ``serve`` also gives the control's decisions: the
scores from operands rounded to TF32's 10-bit mantissa, the step below
the f32 keys, against the same slab.

Imports nothing of the program.
"""
from __future__ import annotations

import hashlib
import re

import numpy as np
import torch

_WORD = re.compile(r"\w+")
_SPLIT = re.compile(r"\w+|[^\w\s]")
PAD_ID, BOS_ID, EOS_ID, UNK_ID, N_SPECIAL = 0, 1, 2, 3, 8


def _h(s: str, salt: int) -> int:
    return int.from_bytes(
        hashlib.blake2s(s.encode(), digest_size=8,
                        salt=salt.to_bytes(8, "little")).digest(), "little")


class Embedder:
    """Signed feature hashing of word uni/bigrams and char 3/4-grams,
    TF-weighted, L2-normalized (the port's ``HashEmbedder`` defaults)."""

    def __init__(self, dim: int = 384):
        self.dim = dim

    def embed(self, text: str) -> np.ndarray:
        text = text.lower().strip()
        words = _WORD.findall(text)
        feats: dict[int, float] = {}

        def add(tok: str, w: float):
            idx = _h(tok, 1) % self.dim
            sign = 1.0 if _h(tok, 2) & 1 else -1.0
            feats[idx] = feats.get(idx, 0.0) + sign * w

        for w_ in words:
            add("w:" + w_, 1.0)
        for a, b in zip(words, words[1:]):
            add("b:" + a + "_" + b, 0.8)
        joined = " ".join(words)
        for n in (3, 4):
            for i in range(len(joined) - n + 1):
                add(f"c{n}:" + joined[i:i + n],
                    0.7 / max(len(joined), 1) * 10)
        v = np.zeros((self.dim,), dtype=np.float32)
        for idx, val in feats.items():
            v[idx] += val
        return v / max(np.linalg.norm(v), 1e-12)

    def embed_batch(self, texts) -> np.ndarray:
        return np.stack([self.embed(t) for t in texts])


class Tokenizer:
    """Word-level signed-hash ids; the decoder's id -> word table grows
    as words are first encoded, so a copy fed the same texts in the same
    order decodes alike."""

    def __init__(self, vocab_size: int = 32768):
        self.vocab_size = vocab_size
        self.table = {PAD_ID: "", BOS_ID: "<s>", EOS_ID: "</s>",
                      UNK_ID: "<unk>"}

    def encode(self, text: str, max_len: int) -> list[int]:
        ids = [BOS_ID]
        for w in _SPLIT.findall(text):
            h = hashlib.blake2s(w.lower().encode(), digest_size=8).digest()
            tid = N_SPECIAL + int.from_bytes(h, "little") % (
                self.vocab_size - N_SPECIAL)
            self.table.setdefault(tid, w.lower())
            ids.append(tid)
        return ids[:max_len]

    def encode_batch(self, texts, max_len: int) -> np.ndarray:
        out = np.full((len(texts), max_len), PAD_ID, dtype=np.int64)
        for i, t in enumerate(texts):
            ids = self.encode(t, max_len)
            out[i, :len(ids)] = ids
        return out

    def decode(self, ids) -> str:
        words = []
        for t in ids:
            t = int(t)
            if t in (PAD_ID, BOS_ID):
                continue
            if t == EOS_ID:
                break
            words.append(self.table.get(t, "<unk>"))
        return " ".join(words)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 explicit mantissa bits), to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class CacheReference:
    """The slab and both tokenizers, replayed in serve order."""

    def __init__(self, deploy: dict, vocab: int, device):
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cap, self.dim = deploy["capacity"], deploy["dim"]
        self.tau, self.value_len = deploy["threshold"], deploy["value_len"]
        self.prompt_len = deploy["max_prompt_len"]
        self.device = device
        self.embedder = Embedder(self.dim)
        self.engine_tok = Tokenizer()
        self.backend_tok = Tokenizer(vocab)
        self.keys = torch.zeros((self.cap, self.dim), dtype=torch.float32,
                                device=device)
        self.valid = torch.zeros((self.cap,), dtype=torch.bool, device=device)
        self.text: list[str | None] = [None] * self.cap
        self.ptr = 0

    def _unit(self, texts) -> torch.Tensor:
        e = torch.as_tensor(self.embedder.embed_batch(texts),
                            device=self.device)
        return e / e.norm(dim=-1, keepdim=True).clamp_min(1e-12)

    def _stored(self, answers) -> list[str]:
        toks = self.engine_tok.encode_batch(answers, self.value_len)
        return [self.engine_tok.decode(t) for t in toks]

    def _insert(self, keys: torch.Tensor, texts: list[str]) -> None:
        n = keys.shape[0]
        slots = (self.ptr + torch.arange(n, device=self.device)) % self.cap
        self.keys[slots] = keys
        self.valid[slots] = True
        for i, s in enumerate(slots.tolist()):
            self.text[s] = texts[i]
        self.ptr = (self.ptr + n) % self.cap

    def warm(self, questions, answers, chunk: int = 256) -> None:
        for i in range(0, len(questions), chunk):
            self._insert(self._unit(questions[i:i + chunk]),
                         self._stored(answers[i:i + chunk]))

    def prompts(self, queries) -> np.ndarray:
        """The backend's padded prompt ids; feeds its decoder's table."""
        return self.backend_tok.encode_batch(queries, self.prompt_len)

    def serve(self, queries, generated: dict[int, np.ndarray], *,
              control: bool = False) -> dict:
        """One batch. ``generated`` maps each row the program sent to the
        model to the tokens it generated. Returns numpy per row: ``hit``,
        ``best`` score, ``slot`` (lowest on ties), ``answer`` expected, the
        (B, N) ``scores`` on the card, and with ``control`` the TF32
        control's ``c_hit``, ``c_best``, ``c_slot``; then inserts this
        reference's misses in row order."""
        unit = self._unit(queries)
        s = (unit @ self.keys.T).masked_fill(~self.valid, float("-inf"))
        out = self._decide(s, "")
        if control:
            c = (_tf32(unit) @ _tf32(self.keys).T).masked_fill(
                ~self.valid, float("-inf"))
            out.update(self._decide(c, "c_"))
        out["scores"] = s
        hit = out["hit"]
        answers: list[str | None] = [None] * len(queries)
        for i in range(len(queries)):
            if hit[i]:
                answers[i] = self.text[out["slot"][i]]
        if control:
            out["c_answer"] = [self.text[out["c_slot"][i]]
                               if out["c_hit"][i] else None
                               for i in range(len(queries))]
        gen_rows = sorted(generated)
        if gen_rows:
            # the backend tokenizes the whole miss set, then reads each row
            self.prompts([queries[i] for i in gen_rows])
            raw = [self.backend_tok.decode(generated[i]) for i in gen_rows]
            for i, a in zip(gen_rows, self._stored(raw)):
                if not hit[i]:
                    answers[i] = a
        out["answer"] = answers
        miss = [i for i in range(len(queries)) if not hit[i]]
        if miss:
            self._insert(unit[torch.as_tensor(miss, device=self.device)],
                         [answers[i] or "" for i in miss])
        return out

    def _decide(self, s: torch.Tensor, prefix: str) -> dict:
        best, slot = s.max(dim=-1)          # first (lowest) slot on ties
        hit = (best >= self.tau) & torch.isfinite(best)
        return {prefix + "hit": hit.cpu().numpy(),
                prefix + "best": best.cpu().numpy(),
                prefix + "slot": slot.cpu().numpy()}

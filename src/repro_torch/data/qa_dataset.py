"""Synthetic QA corpus reproducing the paper's evaluation setup (§3.1–3.2).

Four categories — basics of python programming, technical support related
to network, questions related to order and shipping, customer shopping QA —
with templated generators producing 8,000 unique question/answer pairs for
cache population and 2,000 test queries (500/category). Test queries are a
mix of *paraphrases* of cached questions (lexical substitution, politeness
fillers, clause reordering — the "minor variations" the paper targets) and
*novel* questions drawn from held-out templates, mixed at a ratio chosen to
land in the paper's observed regime (cache hit rates 61.6–68.8%).

Ground truth for the judge: each test query records the ``source_id`` of
the QA pair it paraphrases (-1 for novel queries), so a cache hit is
*positive* iff the matched entry's source equals the query's source — the
offline replacement for the paper's GPT-4o-mini validation (DESIGN.md §9).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable

CATEGORIES = (
    "python_basics",
    "network_support",
    "order_shipping",
    "customer_shopping",
)

# --------------------------------------------------------------------------- #
# template banks
# --------------------------------------------------------------------------- #

_PY_TOPICS = [
    "a list", "a dictionary", "a tuple", "a set", "a string", "a dataframe",
    "a generator", "a decorator", "a lambda", "a class", "a module",
    "a virtual environment", "a csv file", "a json file", "an exception",
    "a loop", "a list comprehension", "a regular expression", "a file",
    "a numpy array",
]
_PY_ACTIONS = [
    "reverse", "sort", "copy", "merge", "iterate over", "slice", "filter",
    "create", "delete items from", "find the length of", "convert to a string",
    "append to", "flatten", "deduplicate", "serialize",
]
_PY_TEMPLATES = [
    "how do i {a} {t} in python",
    "what is the best way to {a} {t} in python",
    "python code to {a} {t}",
    "how can i {a} {t} using python",
    "show me how to {a} {t} in python",
]

_NET_DEVICES = [
    "my router", "the wifi", "my modem", "the vpn", "the ethernet connection",
    "my firewall", "the dns server", "the proxy", "my access point",
    "the network printer", "port forwarding", "my ip address",
    "the dhcp server", "my smart tv connection", "the mesh network",
    "the 5ghz band", "my laptop's wifi adapter", "the guest network",
    "the corporate vpn", "the network switch",
]
_NET_ISSUES = [
    "keeps disconnecting", "is very slow", "won't connect", "shows no internet",
    "drops every few minutes", "has high latency", "is not visible",
    "refuses new devices", "times out", "needs to be reset",
    "blocks a website", "fails authentication", "has packet loss",
    "shows limited connectivity", "won't get an ip address",
]
_NET_TEMPLATES = [
    "why {d} {i}",
    "{d} {i} how do i fix it",
    "what should i do when {d} {i}",
    "how to troubleshoot when {d} {i}",
    "help {d} {i}",
]

_ORDER_ITEMS = [
    "my order", "my package", "my shipment", "the delivery", "my parcel",
    "my replacement item", "my return", "my refund", "the exchange",
    "my pre-order", "the backordered item", "my gift order",
    "the express shipment", "my international order", "the second package",
]
_ORDER_ASKS = [
    "where is", "when will i receive", "how do i track", "can i cancel",
    "how do i change the address for", "what is the status of",
    "why is there a delay with", "how do i return", "who delivers",
    "can i expedite", "how long does it take to get", "what happens to",
    "is there an update on", "how do i get a receipt for",
    "can i reschedule the delivery of",
]
_ORDER_TEMPLATES = [
    "{a} {i}",
    "{a} {i} please",
    "i want to know {a2} {i}",
    "could you tell me {a2} {i}",
    "{a} {i} i ordered last week",
]

_SHOP_PRODUCTS = [
    "this phone", "the laptop", "these headphones", "the smart watch",
    "this camera", "the tablet", "the gaming console", "this tv",
    "the vacuum cleaner", "the coffee machine", "this monitor",
    "the keyboard", "the wireless charger", "this speaker", "the printer",
    "the air fryer", "this backpack", "the office chair", "the desk lamp",
    "the fitness tracker",
]
_SHOP_ASKS = [
    "what are the features of", "does a warranty come with", "what colors are available for",
    "is there a discount on", "what is the battery life of", "how much does shipping cost for",
    "can i pay in installments for", "what is the return policy for",
    "are accessories included with", "when will you restock",
    "what are the dimensions of", "is there a student discount for",
    "does it support fast charging,", "what is the weight of",
    "how does it compare to last year's model,",
]
_SHOP_TEMPLATES = [
    "{a} {p}",
    "{a} {p} exactly",
    "hi {a} {p}",
    "quick question {a} {p}",
    "before i buy {a} {p}",
]

# paraphrase machinery ------------------------------------------------------- #

_SYNONYMS = {
    "how do i": ["how can i", "how would i", "what's the way to", "how to"],
    "what is": ["what's", "tell me", "could you explain", "whats"],
    "best way": ["right way", "easiest way", "proper way", "recommended way"],
    "python": ["python 3", "python language", "py"],
    "fix": ["repair", "resolve", "solve", "sort out"],
    "help": ["assist me", "i need help", "support needed", "please help"],
    "why": ["why does", "any idea why", "for what reason"],
    "slow": ["sluggish", "laggy", "really slow"],
    "receive": ["get", "obtain", "have delivered"],
    "order": ["purchase", "buy"],
    "package": ["parcel", "box", "delivery"],
    "track": ["follow", "locate", "trace"],
    "cancel": ["call off", "stop", "void"],
    "features": ["specs", "specifications", "capabilities"],
    "discount": ["deal", "promo", "price cut", "sale"],
    "return": ["send back", "give back"],
    "warranty": ["guarantee", "coverage"],
    "show me": ["give me an example of", "demonstrate", "walk me through"],
    "create": ["make", "build", "construct"],
    "reverse": ["invert", "flip"],
    "sort": ["order", "arrange"],
    "merge": ["combine", "join"],
    "delete": ["remove", "drop"],
    "disconnecting": ["dropping", "cutting out", "losing connection"],
}

_FILLERS_PRE = ["hey", "hi there", "please", "quick question", "hello",
                "excuse me", "urgent", "sorry to bother you"]
_FILLERS_POST = ["thanks", "thank you", "asap please", "any help appreciated",
                 "cheers", "thanks in advance"]


@dataclasses.dataclass(frozen=True)
class QAPair:
    qa_id: int
    category: str
    question: str
    answer: str
    semantic_key: str = ""   # (topic, intent) — two pairs with the same key
                             # have interchangeable answers (judge oracle)


@dataclasses.dataclass(frozen=True)
class TestQuery:
    query: str
    category: str
    source_id: int     # the QA pair this paraphrases; -1 = novel
    semantic_key: str = ""


def _py_gen(rng: random.Random):
    t = rng.choice(_PY_TOPICS)
    a = rng.choice(_PY_ACTIONS)
    tpl = rng.choice(_PY_TEMPLATES)
    q = tpl.format(a=a, t=t)
    ans = f"To {a} {t} in Python, use the standard idiom; e.g. see the docs for {t.split()[-1]}()."
    return q, ans, f"py|{a}|{t}"


def _net_gen(rng: random.Random):
    d = rng.choice(_NET_DEVICES)
    i = rng.choice(_NET_ISSUES)
    tpl = rng.choice(_NET_TEMPLATES)
    q = tpl.format(d=d, i=i)
    ans = f"When {d} {i}, first power-cycle the device, check cabling, then verify configuration."
    return q, ans, f"net|{d}|{i}"


def _order_gen(rng: random.Random):
    i = rng.choice(_ORDER_ITEMS)
    a = rng.choice(_ORDER_ASKS)
    tpl = rng.choice(_ORDER_TEMPLATES)
    q = tpl.format(a=a, i=i, a2=a.replace("?", ""))
    ans = f"Regarding {i}: check the tracking link in your confirmation email or your account's orders page."
    return q, ans, f"ord|{a}|{i}"


def _shop_gen(rng: random.Random):
    p = rng.choice(_SHOP_PRODUCTS)
    a = rng.choice(_SHOP_ASKS)
    tpl = rng.choice(_SHOP_TEMPLATES)
    q = tpl.format(a=a, p=p)
    ans = f"About {p}: full details including {a.split()[-2] if len(a.split())>1 else 'info'} are on the product page; support can confirm specifics."
    return q, ans, f"shop|{a}|{p}"


_GENS: dict[str, Callable] = {
    "python_basics": _py_gen,
    "network_support": _net_gen,
    "order_shipping": _order_gen,
    "customer_shopping": _shop_gen,
}


def paraphrase(question: str, rng: random.Random, strength: float = 0.5) -> str:
    """Minor-variation rewriting (the paper's repeated-query model)."""
    q = question
    # synonym substitutions (longest-match-first)
    for key in sorted(_SYNONYMS, key=len, reverse=True):
        if key in q and rng.random() < strength:
            q = q.replace(key, rng.choice(_SYNONYMS[key]), 1)
    if rng.random() < 0.4:
        q = f"{rng.choice(_FILLERS_PRE)} {q}"
    if rng.random() < 0.3:
        q = f"{q} {rng.choice(_FILLERS_POST)}"
    if rng.random() < 0.2 and ", " in q:
        a, b = q.split(", ", 1)
        q = f"{b}, {a}"
    return q


def build_corpus(n_per_category: int = 2000, seed: int = 0
                 ) -> list[QAPair]:
    """8,000 unique QA pairs (paper §3.1) at the default size."""
    rng = random.Random(seed)
    pairs: list[QAPair] = []
    qa_id = 0
    for cat in CATEGORIES:
        seen = set()
        gen = _GENS[cat]
        attempts = 0
        while len(seen) < n_per_category and attempts < n_per_category * 80:
            q, a, key = gen(rng)
            attempts += 1
            if q in seen:
                continue
            seen.add(q)
            pairs.append(QAPair(qa_id=qa_id, category=cat, question=q,
                                answer=a, semantic_key=key))
            qa_id += 1
    return pairs


_CATEGORY_STRENGTH = {
    # per-category paraphrase aggressiveness, calibrated so threshold-0.8 hit
    # rates land in the paper's Table-1 band (61.6–68.8 %)
    "python_basics": 0.33,
    "network_support": 0.45,
    "order_shipping": 0.45,
    "customer_shopping": 0.75,
}


def build_test_queries(pairs: list[QAPair], n_per_category: int = 500,
                       paraphrase_ratio: float = 0.75, seed: int = 1,
                       strength: float | None = None) -> list[TestQuery]:
    """2,000 test queries (paper §3.2): paraphrases of cached questions mixed
    with novel ones. ``paraphrase_ratio`` controls the ceiling on the hit
    rate; 0.72 lands the system in the paper's 61–69 % band at threshold
    0.8 with the hash embedder (calibrated in benchmarks)."""
    rng = random.Random(seed)
    by_cat: dict[str, list[QAPair]] = {c: [] for c in CATEGORIES}
    for p in pairs:
        by_cat[p.category].append(p)
    known_questions = {p.question for p in pairs}
    queries: list[TestQuery] = []
    for cat in CATEGORIES:
        pool = by_cat[cat]
        for _ in range(n_per_category):
            cat_strength = strength if strength is not None \
                else _CATEGORY_STRENGTH[cat]
            if rng.random() < paraphrase_ratio and pool:
                src = rng.choice(pool)
                q = paraphrase(src.question, rng, cat_strength)
                queries.append(TestQuery(query=q, category=cat,
                                         source_id=src.qa_id,
                                         semantic_key=src.semantic_key))
            else:
                # novel: generate until it's not an exact cached question
                key = ""
                for _ in range(64):
                    q, _a, key = _GENS[cat](rng)
                    q = paraphrase(q, rng, 0.9)   # heavy rewrite
                    if q not in known_questions:
                        break
                queries.append(TestQuery(query=q, category=cat, source_id=-1,
                                         semantic_key=key))
    rng.shuffle(queries)
    return queries

"""The benchmark's traffic: a frozen copy of the port's QA corpus and
query generators (``repro_torch/data/qa_dataset.py``) and of its open-loop
arrivals (``repro_torch/serving/loadgen.py::run_open_loop``), so that a
change to the program cannot change the yardstick.

Two things differ from the originals. Latency is timed from each
request's due time, not from its submit, so a stall of the generator or
of the server counts (``harness.offer``). And a run's stream is a fixed
multiset of queries and of inter-arrival gaps, both drawn from the traffic
file's own seeds, put in an order drawn from ``--seed``: every seed offers
the same work at the same set of gaps, so seeds differ in order only.
The categories are interleaved (uniform, one in four) and the
paraphrase share is exact, not drawn per query.

Imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
import json
import math
import random
from pathlib import Path
from typing import Callable

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"

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
    semantic_key: str = ""


@dataclasses.dataclass(frozen=True)
class Query:
    query: str
    category: str
    source_id: int     # the QA pair it paraphrases; -1 = novel
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



def load_traffic(name: str) -> dict:
    """The traffic file ``traffic/<name>.json``."""
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def corpus_for(traffic: dict) -> list[QAPair]:
    """The warm corpus (paper §3.1): the same for every seed."""
    return build_corpus(traffic["corpus_per_category"],
                        seed=traffic["corpus_seed"])


def _draw(rng: random.Random, cat: str, by_cat: dict, known: set,
          para: bool, traffic: dict) -> Query:
    """One test query of ``cat``, as ``build_test_queries`` draws it: a
    paraphrase of a cached question, or a novel question rewritten hard
    and kept off the cached questions."""
    if para:
        src = rng.choice(by_cat[cat])
        q = paraphrase(src.question, rng, traffic["strength"][cat])
        return Query(q, cat, src.qa_id, src.semantic_key)
    key = ""
    for _ in range(64):
        q, _a, key = _GENS[cat](rng)
        q = paraphrase(q, rng, traffic["novel_strength"])
        if q not in known:
            break
    return Query(q, cat, -1, key)


def _queries(traffic: dict, corpus: list[QAPair], n: int, seed: int,
             para_share: float) -> list[Query]:
    """``n`` queries from ``random.Random(seed)``: the categories one in
    four, ``round(n * para_share)`` of them paraphrases, the rest novel."""
    rng = random.Random(seed)
    by_cat: dict[str, list[QAPair]] = {c: [] for c in CATEGORIES}
    for p in corpus:
        by_cat[p.category].append(p)
    known = {p.question for p in corpus}
    n_para = round(n * para_share)
    kinds = [True] * n_para + [False] * (n - n_para)
    rng.shuffle(kinds)
    return [_draw(rng, CATEGORIES[i % len(CATEGORIES)], by_cat, known,
                  kinds[i], traffic) for i in range(n)]


@dataclasses.dataclass
class Stream:
    """One run's offered traffic. ``due`` are arrival offsets in seconds
    from the first due time; the window is ``[lead_in_s, lead_in_s +
    seconds)`` of them. ``warmup`` holds the batches served before the
    first arrival."""

    warmup: list[list[Query]]
    queries: list[Query]
    due: list[float]
    lead_in_s: float
    seconds: float


def build_stream(traffic: dict, corpus: list[QAPair], rate_qps: float,
                 seconds: float, seed: int) -> Stream:
    """Open-loop Poisson arrivals at ``rate_qps`` over the lead-in and the
    window: ``n = ceil(rate * span)`` queries and ``n`` gaps, both fixed by
    the traffic file's seeds (a Poisson process holding ``n`` arrivals in
    the span: sorted uniform times), each put in an order drawn from
    ``seed``."""
    lead = float(traffic["lead_in_s"])
    span = lead + float(seconds)
    n = math.ceil(rate_qps * span)
    queries = _queries(traffic, corpus, n, traffic["pool_seed"],
                       traffic["paraphrase_ratio"])
    grng = random.Random(traffic["pool_seed"] + 1)
    times = sorted(grng.random() * span for _ in range(n))
    gaps = [t - s for s, t in zip([0.0] + times[:-1], times)]
    order = random.Random(seed)
    order.shuffle(queries)
    order.shuffle(gaps)
    due, t = [], 0.0
    for g in gaps:
        t += g
        due.append(t)
    warmup = [_queries(traffic, corpus, w["rows"], traffic["pool_seed"] + 2
                       + i, w["paraphrase_ratio"])
              for i, w in enumerate(traffic["warmup"])]
    return Stream(warmup=warmup, queries=queries, due=due, lead_in_s=lead,
                  seconds=float(seconds))

"""KO-EN term-pair mining: MUSE dictionaries, Wikidata labels, Wikipedia
langlinks, curated IT glossary, plus quality filtering and deduplication
(a copy of ``splade_tpu/preprocessing/term_pairs.py``).

Reference: scripts/collect_term_data_v19.py (726 LoC) — four collectors
feeding a filter/dedup stage that produces bilingual-synonym training
pairs. The rebuild separates PARSING (pure, offline-testable: MUSE
whitespace-TSV, Wikidata SPARQL-JSON bindings, Wikipedia langlinks API
JSON) from FETCHING (a pluggable ``fetch(url, params) -> str`` hook,
network-gated on the zero-egress host: local caches under
``$SPLADE_TERM_DATA`` take precedence, and collectors degrade to empty
with a warning when neither cache nor network is available).
"""

from __future__ import annotations

import json
import logging
import os
import re
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

logger = logging.getLogger(__name__)

Pair = Dict[str, str]  # {"ko": ..., "en": ..., "source": ...}

MUSE_URLS = (
    # (url, src_lang) — the public MUSE bilingual dictionaries
    ("https://dl.fbaipublicfiles.com/arrival/dictionaries/ko-en.txt", "ko"),
    ("https://dl.fbaipublicfiles.com/arrival/dictionaries/en-ko.txt", "en"),
)
WIKIDATA_SPARQL_URL = "https://query.wikidata.org/sparql"
WIKIPEDIA_API_URL = "https://ko.wikipedia.org/w/api.php"


# ------------------------------------------------------------- validation
def is_korean(text: str) -> bool:
    from splade_tpu_torch.utils.text import contains_hangul

    return contains_hangul(text)


def is_valid_english(text: str) -> bool:
    """ASCII-lettered, not a long all-caps abbreviation."""
    if not text:
        return False
    if text.isupper() and len(text) > 5:
        return False
    return any(c.isalpha() and c.isascii() for c in text)


def clean_term(text: str) -> str:
    """Trim and drop parenthetical glosses: '서버 (server)' -> '서버'."""
    text = text.strip()
    if "(" in text and ")" in text:
        main = text.split("(")[0].strip()
        if main:
            return main
    return text


# ------------------------------------------------------------- parsers
def parse_muse_lines(lines: Iterable[str], src_lang: str = "ko") -> List[Pair]:
    """MUSE dictionary format: one whitespace-separated pair per line
    (reference: collect_term_data_v19.py:114-130)."""
    pairs: List[Pair] = []
    for line in lines:
        parts = line.strip().split()
        if len(parts) < 2:
            continue
        ko, en = (parts[0], parts[1]) if src_lang == "ko" else (parts[1], parts[0])
        ko, en = ko.strip(), en.strip()
        if is_korean(ko) and is_valid_english(en) and len(ko) >= 2 and len(en) >= 2:
            pairs.append({"ko": ko, "en": en.lower(), "source": "muse"})
    return pairs


def parse_wikidata_bindings(payload: dict) -> List[Pair]:
    """SPARQL JSON results with ``koLabel``/``enLabel`` variables
    (reference: collect_term_data_v19.py:198-230)."""
    pairs: List[Pair] = []
    for b in payload.get("results", {}).get("bindings", []):
        ko = clean_term(b.get("koLabel", {}).get("value", ""))
        en = clean_term(b.get("enLabel", {}).get("value", ""))
        if ko and en and is_korean(ko) and is_valid_english(en):
            pairs.append({"ko": ko, "en": en.lower(), "source": "wikidata"})
    return pairs


def parse_wikipedia_langlinks(payload: dict) -> List[Pair]:
    """MediaWiki API ``prop=langlinks`` response: page title (ko) ->
    English langlink title (reference: collect_term_data_v19.py:280-330)."""
    pairs: List[Pair] = []
    for page in payload.get("query", {}).get("pages", {}).values():
        ko = clean_term(page.get("title", ""))
        if not is_korean(ko):
            continue
        for ll in page.get("langlinks", []):
            if ll.get("lang") == "en":
                en = clean_term(ll.get("*", "") or ll.get("title", ""))
                if en and is_valid_english(en):
                    pairs.append({"ko": ko, "en": en.lower(),
                                  "source": "wikipedia"})
    return pairs


# ------------------------------------------------------------- collectors
def _term_data_root() -> Optional[Path]:
    root = os.environ.get("SPLADE_TERM_DATA")
    return Path(root) if root else None


def _default_fetch(url: str, params: Optional[dict] = None) -> str:
    import urllib.parse
    import urllib.request

    if params:
        url = url + "?" + urllib.parse.urlencode(params)
    req = urllib.request.Request(url, headers={"User-Agent": "splade-tpu/1.0"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read().decode("utf-8", "replace")


def collect_muse(fetch: Optional[Callable] = None) -> List[Pair]:
    """MUSE pairs from ``$SPLADE_TERM_DATA/muse/*.txt`` (filename declares
    direction: 'en-ko*' parses EN-first) or the public URLs when a fetch
    hook/network is available."""
    root = _term_data_root()
    pairs: List[Pair] = []
    if root:
        # preferred layout: $SPLADE_TERM_DATA/muse/*.txt; also honor
        # dictionaries dropped at the root (the pre-muse/ layout) so
        # existing hosts keep working without a re-layout
        dirs = [d for d in (root / "muse", root) if d.exists()]
        files = sorted({fp for d in dirs for fp in d.glob("*.txt")})
        for fp in files:
            src = "en" if fp.name.startswith("en-") else "ko"
            pairs.extend(parse_muse_lines(
                fp.read_text(encoding="utf-8").splitlines(), src))
        if files:
            logger.info("MUSE (local cache, %d files): %d pairs",
                        len(files), len(pairs))
            return pairs
    fetch = fetch or _default_fetch
    for url, src in MUSE_URLS:
        try:
            pairs.extend(parse_muse_lines(fetch(url).splitlines(), src))
        except Exception as e:  # zero-egress host / transient
            logger.warning("MUSE fetch failed (%s): %s", url, e)
    logger.info("MUSE: %d pairs", len(pairs))
    return pairs


WIKIDATA_QUERY = """
SELECT ?koLabel ?enLabel WHERE {
  ?item wdt:P31/wdt:P279* wd:Q151885 .
  ?item rdfs:label ?koLabel filter(lang(?koLabel) = "ko") .
  ?item rdfs:label ?enLabel filter(lang(?enLabel) = "en") .
} LIMIT %d"""


def collect_wikidata(fetch: Optional[Callable] = None,
                     limit: int = 20000) -> List[Pair]:
    """Wikidata concept labels via SPARQL, or the local cache file
    ``$SPLADE_TERM_DATA/wikidata.json`` (SPARQL JSON results)."""
    root = _term_data_root()
    if root and (root / "wikidata.json").exists():
        pairs = parse_wikidata_bindings(
            json.loads((root / "wikidata.json").read_text(encoding="utf-8")))
        logger.info("Wikidata (local cache): %d pairs", len(pairs))
        return pairs
    fetch = fetch or _default_fetch
    try:
        raw = fetch(WIKIDATA_SPARQL_URL,
                    {"query": WIKIDATA_QUERY % limit, "format": "json"})
        pairs = parse_wikidata_bindings(json.loads(raw))
    except Exception as e:
        logger.warning("Wikidata fetch failed: %s", e)
        return []
    logger.info("Wikidata: %d pairs", len(pairs))
    return pairs


def collect_wikipedia(fetch: Optional[Callable] = None,
                      target_pairs: int = 10000,
                      batches: int = 40) -> List[Pair]:
    """Korean Wikipedia langlinks mining, or the local cache file
    ``$SPLADE_TERM_DATA/wikipedia_langlinks.jsonl`` (one API response
    payload per line)."""
    root = _term_data_root()
    if root and (root / "wikipedia_langlinks.jsonl").exists():
        pairs: List[Pair] = []
        with open(root / "wikipedia_langlinks.jsonl", encoding="utf-8") as f:
            for line in f:
                pairs.extend(parse_wikipedia_langlinks(json.loads(line)))
        logger.info("Wikipedia (local cache): %d pairs", len(pairs))
        return pairs
    fetch = fetch or _default_fetch
    pairs = []
    try:
        for _ in range(batches):
            raw = fetch(WIKIPEDIA_API_URL, {
                "action": "query", "generator": "random",
                "grnnamespace": 0, "grnlimit": 50,
                "prop": "langlinks", "lllang": "en", "lllimit": 50,
                "format": "json"})
            pairs.extend(parse_wikipedia_langlinks(json.loads(raw)))
            if len(pairs) >= target_pairs:
                break
    except Exception as e:
        logger.warning("Wikipedia fetch failed: %s", e)
    logger.info("Wikipedia: %d pairs", len(pairs))
    return pairs


# ------------------------------------------------------------- filtering
def filter_and_deduplicate(pairs: Iterable[Pair]
                           ) -> Tuple[List[Pair], Dict[str, int]]:
    """Quality filter + (ko, en)-key dedup with rejection accounting
    (reference: collect_term_data_v19.py:583-656)."""
    rejected: Dict[str, int] = defaultdict(int)
    filtered: List[Pair] = []
    for pair in pairs:
        ko, en = pair["ko"], pair["en"]
        if len(ko) < 2:
            rejected["ko_too_short"] += 1
        elif len(en) < 2:
            rejected["en_too_short"] += 1
        elif len(ko) > 30:
            rejected["ko_too_long"] += 1
        elif len(en) > 50:
            rejected["en_too_long"] += 1
        elif not is_korean(ko):
            rejected["no_korean"] += 1
        elif not is_valid_english(en):
            rejected["invalid_english"] += 1
        elif len(re.sub(r"[^a-zA-Z]", "", en)) < 2:
            rejected["en_no_letters"] += 1
        else:
            filtered.append(pair)
    seen = set()
    unique: List[Pair] = []
    for pair in filtered:
        key = (pair["ko"].strip(), pair["en"].strip().lower())
        if key not in seen:
            seen.add(key)
            unique.append(pair)
    rejected["duplicates"] = len(filtered) - len(unique)
    return unique, dict(rejected)


def pairs_to_triplets(pairs: Iterable[Pair]) -> List[dict]:
    """Term pairs -> pair-type training rows (query=ko, positive embeds
    the EN synonym so the model learns the cross-lingual bridge)."""
    return [{"query": p["ko"], "positive": f"{p['ko']} ({p['en']})",
             "pair_type": "term", "source": f"term_{p['source']}"}
            for p in pairs]

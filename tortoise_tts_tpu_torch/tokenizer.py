"""Text frontend: english cleaners + BPE tokenizer (reference tokenizer.py).

The port's own copy of ``tortoise_tts_tpu/tokenizer.py`` (the port
imports nothing from the JAX package).  Pure-Python, dependency-free:
- english_cleaners (tokenizer.py:144-152): ASCII transliteration,
  lowercase, number/abbreviation expansion, whitespace collapse.  The
  reference leans on `inflect`/`unidecode`; equivalents are implemented
  here (number-to-words incl. year grouping and ordinals, NFD-based
  transliteration).
- VoiceBpeTokenizer (tokenizer.py:154-178): loads the HF-format
  tokenizer.json (BPE, Whitespace pre-tokenizer, [STOP]/[UNK]/[SPACE]
  specials) without the `tokenizers` runtime.

The default vocab file is searched in: explicit path, $TORTOISE_TPU_TOKENIZER,
then the package data dir.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# number expansion (inflect-equivalent subset)
# ---------------------------------------------------------------------------

_UNITS = ["zero", "one", "two", "three", "four", "five", "six", "seven",
          "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
          "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10 ** 33, "decillion"), (10 ** 30, "nonillion"),
           (10 ** 27, "octillion"), (10 ** 24, "septillion"),
           (10 ** 21, "sextillion"), (10 ** 18, "quintillion"),
           (10 ** 15, "quadrillion"), (10 ** 12, "trillion"),
           (10 ** 9, "billion"), (10 ** 6, "million"),
           (10 ** 3, "thousand")]

_ORDINAL_MAP = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int, zero: str = "zero") -> str:
    if n == 0:
        return zero
    if n < 20:
        return _UNITS[n]
    t, u = divmod(n, 10)
    return _TENS[t] + ("-" + _UNITS[u] if u else "")


def _three_digits(n: int) -> str:
    h, rest = divmod(n, 100)
    parts = []
    if h:
        parts.append(_UNITS[h] + " hundred")
    if rest:
        parts.append(_two_digits(rest))
    return " ".join(parts)


def number_to_words(n: int, group: int = 0, zero: str = "zero") -> str:
    """English cardinal words, inflect-compatible for the cleaner's uses.

    group=2 reads digit pairs (year style): 1985 -> 'nineteen eighty-five',
    1905 -> 'nineteen oh five' (with zero='oh').
    """
    if n < 0:
        return "minus " + number_to_words(-n, group, zero)
    if group == 2:
        s = str(n)
        if len(s) % 2:
            s = "0" + s
        pairs = [s[i:i + 2] for i in range(0, len(s), 2)]
        words = []
        for pr in pairs:
            v = int(pr)
            if v == 0:
                words.append(f"{zero} {zero}")
            elif v < 10:       # leading zero spoken: '05' -> 'oh five'
                words.append(f"{zero} {_UNITS[v]}")
            else:
                words.append(_two_digits(v))
        return " ".join(words)
    if n == 0:
        return zero
    parts = []
    for scale, name in _SCALES:
        q, n = divmod(n, scale)
        if q:
            # q can exceed 999 only past the top scale (>= 10^36):
            # recurse rather than crash _three_digits
            word = (_three_digits(q) if q < 1000
                    else number_to_words(q, 0, zero))
            parts.append(word + " " + name)
    if n:
        parts.append(_three_digits(n))
    return ", ".join(parts)


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    # make the final word ordinal
    head, _, last = words.rpartition(" ")
    head = head.rstrip(",")   # 'one thousand, first' -> 'one thousand first'
    hy_head, _, hy_last = last.rpartition("-")
    if hy_last in _ORDINAL_MAP:
        ord_last = _ORDINAL_MAP[hy_last]
    elif hy_last.endswith("y"):
        ord_last = hy_last[:-1] + "ieth"
    else:
        ord_last = hy_last + "th"
    last = (hy_head + "-" if hy_head else "") + ord_last
    return (head + " " if head else "") + last


# ---------------------------------------------------------------------------
# cleaners (tokenizer.py:15-152)
# ---------------------------------------------------------------------------

_whitespace_re = re.compile(r"\s+")
_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")

_ABBREVIATIONS = [(re.compile(r"\b%s\." % abbr, re.IGNORECASE), full)
                  for abbr, full in [
    ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
    ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
    ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
    ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
    ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
]]


_LATIN_MAP = {"æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE", "ß": "ss",
              "ø": "o", "Ø": "O", "đ": "d", "Đ": "D", "þ": "th",
              "Þ": "Th", "ð": "d", "Ð": "D", "ł": "l", "Ł": "L",
              "—": "-", "–": "-", "‘": "'", "’": "'", "“": '"',
              "”": '"', "…": "...", "€": " euro ", "£": " pound ",
              "¥": " yen "}
# unidecode-style transliteration for the two most common non-Latin
# scripts — deleting them outright collapses e.g. 'Москва' to ''
_CYRILLIC = {"а": "a", "б": "b", "в": "v", "г": "g", "д": "d", "е": "e",
             "ё": "e", "ж": "zh", "з": "z", "и": "i", "й": "i", "к": "k",
             "л": "l", "м": "m", "н": "n", "о": "o", "п": "p", "р": "r",
             "с": "s", "т": "t", "у": "u", "ф": "f", "х": "kh",
             "ц": "ts", "ч": "ch", "ш": "sh", "щ": "shch", "ъ": "",
             "ы": "y", "ь": "", "э": "e", "ю": "yu", "я": "ya"}
_GREEK = {"α": "a", "β": "b", "γ": "g", "δ": "d", "ε": "e", "ζ": "z",
          "η": "e", "θ": "th", "ι": "i", "κ": "k", "λ": "l", "μ": "m",
          "ν": "n", "ξ": "x", "ο": "o", "π": "p", "ρ": "r", "σ": "s",
          "ς": "s", "τ": "t", "υ": "y", "φ": "ph", "χ": "ch",
          "ψ": "ps", "ω": "o"}


def convert_to_ascii(text: str) -> str:
    """unidecode-equivalent for the common cases: NFKD + strip
    combining, Latin special forms, Cyrillic/Greek transliteration."""
    out = []
    for ch in unicodedata.normalize("NFKD", text):
        if unicodedata.combining(ch):
            continue
        if ord(ch) < 128:
            out.append(ch)
            continue
        if ch in _LATIN_MAP:
            out.append(_LATIN_MAP[ch])
            continue
        low = ch.lower()
        tr = _CYRILLIC.get(low) or _GREEK.get(low)
        if tr is not None:
            out.append(tr.capitalize() if ch != low else tr)
        else:
            out.append("")
    return "".join(out)


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        du = "dollar" if dollars == 1 else "dollars"
        cu = "cent" if cents == 1 else "cents"
        return f"{dollars} {du}, {cents} {cu}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return number_to_words(num, group=2, zero="oh")
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, lambda m: m.group(1).replace(",", ""), text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re,
                  lambda m: m.group(1).replace(".", " point "), text)
    text = re.sub(_ordinal_re,
                  lambda m: ordinal_to_words(int(re.sub(r"\D", "", m.group(0)))),
                  text)
    text = re.sub(_number_re, _expand_number, text)
    return text


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _ABBREVIATIONS:
        text = re.sub(regex, replacement, text)
    return text


def english_cleaners(text: str) -> str:
    text = convert_to_ascii(text)
    text = text.lower()
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    text = re.sub(_whitespace_re, " ", text)
    text = text.replace('"', "")
    return text


# ---------------------------------------------------------------------------
# BPE (HF tokenizers format, Whitespace pre-tokenizer)
# ---------------------------------------------------------------------------

_WHITESPACE_SPLIT = re.compile(r"\w+|[^\w\s]+")

DEFAULT_TOKENIZER_PATHS = [
    Path(__file__).parent / "data" / "tokenizer.json",
]


def find_tokenizer_file(path: Optional[str | Path] = None) -> Path:
    if path is not None:
        return Path(path)
    env = os.environ.get("TORTOISE_TPU_TOKENIZER")
    if env:
        return Path(env)
    for p in DEFAULT_TOKENIZER_PATHS:
        if p.exists():
            return p
    raise FileNotFoundError(
        "no tokenizer.json found; set TORTOISE_TPU_TOKENIZER")


class VoiceBpeTokenizer:
    """HF-tokenizers-compatible BPE over the reference's 255-symbol vocab.

    [STOP]=0, [UNK]=1, [SPACE]=2; spaces become [SPACE] (tokenizer.py:165).
    """

    def __init__(self, tokenizer_file: Optional[str | Path] = None):
        spec = json.loads(find_tokenizer_file(tokenizer_file).read_text())
        self.vocab: Dict[str, int] = dict(spec["model"]["vocab"])
        for tok in spec.get("added_tokens", []):
            self.vocab.setdefault(tok["content"], tok["id"])
        merges = spec["model"]["merges"]
        self.merge_ranks: Dict[Tuple[str, str], int] = {}
        for rank, m in enumerate(merges):
            a, b = m.split(" ") if isinstance(m, str) else m
            self.merge_ranks[(a, b)] = rank
        self.unk = spec["model"].get("unk_token", "[UNK]")
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.specials = {t["content"] for t in spec.get("added_tokens", [])}

    def preprocess_text(self, txt: str) -> str:
        return english_cleaners(txt)

    def _bpe_word(self, word: str) -> List[str]:
        pieces = list(word)
        while len(pieces) > 1:
            best_rank, best_i = None, None
            for i in range(len(pieces) - 1):
                r = self.merge_ranks.get((pieces[i], pieces[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_i is None:
                break
            pieces[best_i: best_i + 2] = [pieces[best_i] + pieces[best_i + 1]]
        return pieces

    def encode(self, txt: str) -> List[int]:
        txt = self.preprocess_text(txt)
        txt = txt.replace(" ", "[SPACE]")
        ids: List[int] = []
        # split out special tokens first (added-token extraction)
        pattern = "(" + "|".join(re.escape(s) for s in self.specials) + ")"
        for part in re.split(pattern, txt):
            if not part:
                continue
            if part in self.specials:
                ids.append(self.vocab[part])
                continue
            for word in _WHITESPACE_SPLIT.findall(part):
                for piece in self._bpe_word(word):
                    ids.append(self.vocab.get(piece, self.vocab[self.unk]))
        return ids

    def decode(self, seq: Sequence[int]) -> str:
        toks = [self.inv_vocab.get(int(i), "") for i in seq]
        txt = "".join(toks)
        txt = txt.replace("[SPACE]", " ")
        txt = txt.replace("[STOP]", "")
        txt = txt.replace("[UNK]", "")
        return txt

    def get_vocab(self) -> Dict[str, int]:
        return dict(self.vocab)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


@lru_cache(maxsize=1)
def default_tokenizer() -> VoiceBpeTokenizer:
    return VoiceBpeTokenizer()


def tokenize(text: str) -> List[int]:
    return default_tokenizer().encode(text)


def get_phone_symmap() -> Dict[str, int]:
    """Token -> id map (reference data.py:276-277), embedded in exported
    weights."""
    return default_tokenizer().get_vocab()


def write_char_tokenizer(path: str | Path) -> Path:
    """Write a small HF-format character-level ``tokenizer.json``.

    For runs without the reference vocab file (random-weight tests and
    the chip smoke run): [STOP]=0, [UNK]=1, [SPACE]=2, then the
    lower-case letters and the punctuation the cleaners leave, plus a
    few merges so the BPE loop runs.  Every id stays below the
    UnifiedVoice text vocabulary (255)."""
    symbols = list("abcdefghijklmnopqrstuvwxyz'.,!?-;:")
    merges = ["t h", "th e", "i n", "e r", "a n"]
    vocab = {"[STOP]": 0, "[UNK]": 1, "[SPACE]": 2}
    for s in symbols + [m.replace(" ", "") for m in merges]:
        vocab.setdefault(s, len(vocab))
    spec = {
        "added_tokens": [{"id": i, "content": t} for t, i in vocab.items()
                         if t.startswith("[")],
        "model": {"type": "BPE", "unk_token": "[UNK]", "vocab": vocab,
                  "merges": merges},
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(spec))
    return path

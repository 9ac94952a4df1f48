"""Transcript post-processing: punctuation restoration + inverse text
normalization (ITN) (ports livetalking_tpu/server/textnorm.py).

The reference's local STT backend (SenseVoiceSmall via funasr, reference
server/asr_server.py:70-116) returns punctuated, ITN-normalized text
through ``rich_transcription_postprocess``. The Whisper-tiny greedy path
produces raw (often punctuation-poor) text; this module closes the
transcript-quality gap with a light rule-based host pass:

- ``restore_punctuation``: whitespace cleanup, sentence-initial
  capitalization (Latin), and a sentence-final mark (``.`` / ``。``)
  chosen by script when the model emitted none.
- ``inverse_normalize``: spoken-form numbers to written form for English
  ("twenty three percent" -> "23%") and Chinese ("三百零五" -> "305"),
  the dominant ITN rewrite funasr's client protocol toggles via the
  ``itn`` config flag.

Both are pure host-side string passes (no model), applied in the ``/api/asr``
handler behind the same ``itn`` flag the FunASR protocol carries.
"""

from __future__ import annotations

import re

__all__ = ["restore_punctuation", "inverse_normalize", "postprocess"]

_CJK = re.compile(r"[一-鿿㐀-䶿]")
_TERMINAL = ".!?。！？…"

# ---------------------------------------------------------------------------
# punctuation
# ---------------------------------------------------------------------------


def restore_punctuation(text: str) -> str:
    """Normalize whitespace, capitalize Latin sentence starts, and ensure
    a terminal mark matched to the dominant script."""
    t = re.sub(r"\s+", " ", text).strip()
    if not t:
        return t
    # drop space before existing punctuation ("hello ." -> "hello.")
    t = re.sub(r"\s+([,.!?;:，。！？；：])", r"\1", t)
    # capitalize the first Latin letter of each sentence
    parts = re.split(r"([.!?。！？]+\s*)", t)
    out = []
    for seg in parts:
        m = re.search(r"[A-Za-z]", seg)
        if m and not re.match(r"[.!?。！？]", seg):
            i = m.start()
            seg = seg[:i] + seg[i].upper() + seg[i + 1:]
        out.append(seg)
    t = "".join(out)
    if t[-1] not in _TERMINAL:
        t += "。" if _CJK.search(t[-10:] or t) else "."
    return t


# ---------------------------------------------------------------------------
# English ITN
# ---------------------------------------------------------------------------

_ONES = {
    "zero": 0, "one": 1, "two": 2, "three": 3, "four": 4, "five": 5,
    "six": 6, "seven": 7, "eight": 8, "nine": 9, "ten": 10, "eleven": 11,
    "twelve": 12, "thirteen": 13, "fourteen": 14, "fifteen": 15,
    "sixteen": 16, "seventeen": 17, "eighteen": 18, "nineteen": 19,
}
_TENS = {
    "twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
    "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90,
}
_SCALES = {"hundred": 100, "thousand": 1_000, "million": 1_000_000,
           "billion": 1_000_000_000}
_NUMWORDS = set(_ONES) | set(_TENS) | set(_SCALES) | {"and"}


def _en_words_to_int(words) -> int:
    total, current = 0, 0
    for w in words:
        if w in _ONES:
            current += _ONES[w]
        elif w in _TENS:
            current += _TENS[w]
        elif w == "hundred":
            current = max(current, 1) * 100
        elif w in _SCALES:  # thousand/million/billion close a group
            total += max(current, 1) * _SCALES[w]
            current = 0
        # "and" is glue ("three hundred and five")
    return total + current


def _cat(word: str) -> str:
    if word in _SCALES:
        return "scale"
    if word in _TENS:
        return "tens"
    return "ones"


def _valid_next(prev_cat: str, nxt: str) -> bool:
    """English number grammar: within one number, a following word must
    step DOWN in magnitude or be a scale ("twenty three", "three
    hundred") — "three thirty" / "five two" are two separate numbers
    (times, digit strings), not 33/52."""
    c = _cat(nxt)
    if prev_cat == "":
        return True
    if c == "scale":
        return True
    if prev_cat == "scale":
        return True
    if prev_cat == "tens" and c == "ones":
        return True
    return False


def _en_itn(text: str) -> str:
    """Rewrite spoken-number spans to digits. Conservative: a span is
    rewritten when it is multi-word or names a value >= 10 (a lone
    "one"/"two" is usually a determiner, not a numeral)."""
    tokens = re.split(r"(\s+)", text)
    out = []
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        bare = re.sub(r"[^A-Za-z\-]", "", tok).lower()
        words = [w for w in bare.split("-") if w]
        if words and all(w in _NUMWORDS for w in words) and bare != "and":
            span = list(words)
            prev_cat = _cat(words[-1])
            j = i + 1   # resume position: just AFTER the last absorbed token
            probe = i + 1
            last_tok = tok
            while probe < len(tokens):
                if tokens[probe].isspace():
                    probe += 1
                    continue
                nbare = re.sub(r"[^A-Za-z\-]", "", tokens[probe]).lower()
                nwords = [w for w in nbare.split("-") if w]
                if not (nwords and all(w in _NUMWORDS for w in nwords)):
                    break
                if nbare == "and":
                    # the "hundred and five" idiom only: "and" continues
                    # a span solely after a scale word, and only when a
                    # smaller number word follows
                    k = probe + 1
                    while k < len(tokens) and tokens[k].isspace():
                        k += 1
                    kbare = (re.sub(r"[^A-Za-z\-]", "", tokens[k]).lower()
                             if k < len(tokens) else "")
                    if (prev_cat == "scale" and kbare in _NUMWORDS
                            and kbare != "and"
                            and _cat(kbare) != "scale"):
                        span.append("and")
                        probe += 1
                        j = probe
                        continue
                    break
                if not all(_valid_next(prev_cat if wi == 0
                                       else _cat(nwords[wi - 1]), w)
                           for wi, w in enumerate(nwords)):
                    break
                span.extend(nwords)
                prev_cat = _cat(nwords[-1])
                last_tok = tokens[probe]
                probe += 1
                j = probe
            real = [w for w in span if w != "and"]
            value = _en_words_to_int(span)
            if len(real) >= 2 or value >= 10:
                tail = re.sub(r"^[A-Za-z\-]+", "", last_tok)
                out.append(str(value) + tail)
                i = j
                continue
        out.append(tok)
        i += 1
    t = "".join(out)
    t = re.sub(r"(\d+)\s*percent", r"\1%", t, flags=re.IGNORECASE)
    t = re.sub(r"(\d+)\s*dollars?\b", r"$\1", t, flags=re.IGNORECASE)
    return _merge_time_year(t)


# Spoken time/year pairs: the number grammar correctly refuses to join
# "three thirty" / "nineteen ninety eight" into one cardinal, but the
# split halves read worse than the words ("three 30", "19 98"). Merge
# the two classic pair idioms after digitization: clock times (with a
# preposition cue or trailing am/pm — conservative, since a bare pair is
# ambiguous) and 13xx-20xx years (no cue needed; that pair shape is
# almost always a year in speech).
_HOUR_WORDS = {"one": 1, "two": 2, "three": 3, "four": 4, "five": 5,
               "six": 6, "seven": 7, "eight": 8, "nine": 9, "ten": 10,
               "eleven": 11, "twelve": 12}
_TIME_CUE = r"(?:at|by|around|until|till|before|after)"
_HW_ALT = "|".join(_HOUR_WORDS)


def _as_hour(tok: str):
    v = _HOUR_WORDS.get(tok.lower())
    if v is None:
        try:
            v = int(tok)
        except ValueError:
            return None
    return v if 0 <= v <= 23 else None


def _merge_time_year(t: str) -> str:
    def time_sub(m: re.Match) -> str:
        h = _as_hour(m.group(2))
        if h is None or not 10 <= int(m.group(3)) <= 59:
            return m.group(0)
        return f"{m.group(1)} {h}:{m.group(3)}"

    t = re.sub(rf"\b({_TIME_CUE})\s+((?:{_HW_ALT})|\d{{1,2}})\s+(\d{{2}})\b",
               time_sub, t, flags=re.IGNORECASE)

    def ampm_sub(m: re.Match) -> str:
        h = _as_hour(m.group(1))
        if h is None or not 10 <= int(m.group(2)) <= 59:
            return m.group(0)
        return f"{h}:{m.group(2)} {m.group(3)}"

    t = re.sub(rf"\b((?:{_HW_ALT})|\d{{1,2}})\s+(\d{{2}})\s*"
               r"(am|pm|a\.m\.|p\.m\.)\b",
               ampm_sub, t, flags=re.IGNORECASE)
    # "nineteen ninety eight" -> "19 98" -> "1998"; "twenty twenty" -> 2020
    t = re.sub(r"\b(1[3-9]|20)\s+([1-9]\d)\b", r"\1\2", t)
    return t


# ---------------------------------------------------------------------------
# Chinese ITN
# ---------------------------------------------------------------------------

_ZH_DIG = {"零": 0, "一": 1, "二": 2, "两": 2, "三": 3, "四": 4,
           "五": 5, "六": 6, "七": 7, "八": 8, "九": 9}
_ZH_UNIT = {"十": 10, "百": 100, "千": 1000}
_ZH_GROUP = {"万": 10_000, "亿": 100_000_000}
_ZH_NUM = re.compile("[零一二两三四五六七八九十百千万亿]+")


def _zh_words_to_int(s: str) -> int:
    total, section, value = 0, 0, 0
    for ch in s:
        if ch in _ZH_DIG:
            value = _ZH_DIG[ch]
        elif ch in _ZH_UNIT:
            section += max(value, 1) * _ZH_UNIT[ch]
            value = 0
        elif ch in _ZH_GROUP:
            total += (section + value) * _ZH_GROUP[ch]
            section = value = 0
    return total + section + value


def _zh_itn(text: str) -> str:
    # percentage idiom FIRST ("百分之三十" -> "30%"): its 百 is part of
    # the construction, not a hundreds digit
    text = re.sub(
        r"百分之([零一二两三四五六七八九十百千点]+)",
        lambda m: str(_zh_words_to_int(m.group(1))) + "%", text)

    def sub(m: re.Match) -> str:
        s = m.group(0)
        # single digit words ("一" in "一起") stay; 十+ constructs convert
        if len(s) == 1 and s not in _ZH_UNIT:
            return s
        if set(s) <= {"零"}:
            return s
        return str(_zh_words_to_int(s))

    return _ZH_NUM.sub(sub, text)


def inverse_normalize(text: str) -> str:
    """Spoken-form numbers -> written form (en + zh)."""
    return _zh_itn(_en_itn(text))


def postprocess(text: str, itn: bool = True) -> str:
    """The full SenseVoice-parity post-pass: ITN (optional) + punctuation
    (reference server/asr_server.py:70-116 rich_transcription output)."""
    if itn:
        text = inverse_normalize(text)
    return restore_punctuation(text)

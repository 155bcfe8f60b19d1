"""JavaScript (ES5 subset) tokenizer.

Hand-written scanner in the style of the engine's SQL tokenizer.
Produces (kind, value, pos) tuples; kinds: num, str, ident, keyword,
punct, regex, eof.
"""

from __future__ import annotations

from typing import List, NamedTuple


class Token(NamedTuple):
    kind: str
    value: str
    pos: int
    line: int


KEYWORDS = {
    "var", "function", "return", "if", "else", "for", "while", "do",
    "break", "continue", "new", "delete", "typeof", "instanceof", "in",
    "this", "null", "true", "false", "undefined", "throw", "try",
    "catch", "finally", "switch", "case", "default", "void",
    # reserved-but-unsupported words we still lex as keywords so the
    # parser can raise a clear error:
    "class", "const", "let", "with", "yield",
}

# longest first
PUNCT = [
    ">>>=", "===", "!==", ">>>", "<<=", ">>=", "**", "=>",
    "==", "!=", "<=", ">=", "&&", "||", "++", "--", "+=", "-=", "*=",
    "/=", "%=", "&=", "|=", "^=", "<<", ">>",
    "{", "}", "(", ")", "[", "]", ";", ",", "<", ">", "+", "-", "*",
    "/", "%", "&", "|", "^", "!", "~", "?", ":", "=", ".",
]

_ESCAPES = {
    "n": "\n", "t": "\t", "r": "\r", "b": "\b", "f": "\f", "v": "\v",
    "0": "\0", "'": "'", '"': '"', "\\": "\\", "/": "/", "\n": "",
}


class JSSyntaxError(Exception):
    pass


def tokenize(src: str) -> List[Token]:
    toks: List[Token] = []
    i, n, line = 0, len(src), 1
    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r\f\v":
            i += 1
            continue
        if src.startswith("//", i):
            j = src.find("\n", i)
            i = n if j < 0 else j
            continue
        if src.startswith("/*", i):
            j = src.find("*/", i + 2)
            if j < 0:
                raise JSSyntaxError(f"unterminated comment at line {line}")
            line += src.count("\n", i, j)
            i = j + 2
            continue
        if c in "'\"":
            j = i + 1
            buf = []
            while j < n and src[j] != c:
                if src[j] == "\\":
                    if j + 1 >= n:
                        raise JSSyntaxError(
                            f"unterminated string at line {line}")
                    e = src[j + 1]
                    if e == "u":
                        buf.append(chr(int(src[j + 2 : j + 6], 16)))
                        j += 6
                        continue
                    if e == "x":
                        buf.append(chr(int(src[j + 2 : j + 4], 16)))
                        j += 4
                        continue
                    buf.append(_ESCAPES.get(e, e))
                    j += 2
                    continue
                if src[j] == "\n":
                    raise JSSyntaxError(
                        f"unterminated string at line {line}")
                buf.append(src[j])
                j += 1
            if j >= n:
                raise JSSyntaxError(f"unterminated string at line {line}")
            toks.append(Token("str", "".join(buf), i, line))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            if src.startswith("0x", i) or src.startswith("0X", i):
                j = i + 2
                while j < n and src[j] in "0123456789abcdefABCDEF":
                    j += 1
            else:
                while j < n and src[j].isdigit():
                    j += 1
                if j < n and src[j] == ".":
                    j += 1
                    while j < n and src[j].isdigit():
                        j += 1
                if j < n and src[j] in "eE":
                    k = j + 1
                    if k < n and src[k] in "+-":
                        k += 1
                    if k < n and src[k].isdigit():
                        j = k
                        while j < n and src[j].isdigit():
                            j += 1
            toks.append(Token("num", src[i:j], i, line))
            i = j
            continue
        if c.isalpha() or c in "_$":
            j = i
            while j < n and (src[j].isalnum() or src[j] in "_$"):
                j += 1
            word = src[i:j]
            toks.append(
                Token("keyword" if word in KEYWORDS else "ident",
                      word, i, line))
            i = j
            continue
        if c == "/" and _regex_allowed(toks):
            # regex literal: /pattern/flags
            j = i + 1
            in_class = False
            while j < n:
                if src[j] == "\\":
                    j += 2
                    continue
                if src[j] == "[":
                    in_class = True
                elif src[j] == "]":
                    in_class = False
                elif src[j] == "/" and not in_class:
                    break
                elif src[j] == "\n":
                    raise JSSyntaxError(
                        f"unterminated regex at line {line}")
                j += 1
            if j >= n:
                raise JSSyntaxError(f"unterminated regex at line {line}")
            k = j + 1
            while k < n and src[k].isalpha():
                k += 1
            toks.append(Token("regex", src[i:k], i, line))
            i = k
            continue
        for p in PUNCT:
            if src.startswith(p, i):
                toks.append(Token("punct", p, i, line))
                i += len(p)
                break
        else:
            raise JSSyntaxError(
                f"unexpected character {c!r} at line {line}")
    toks.append(Token("eof", "", n, line))
    return toks


def _regex_allowed(toks: List[Token]) -> bool:
    """A '/' starts a regex when the previous token can't end an
    expression (standard JS lexer disambiguation)."""
    if not toks:
        return True
    t = toks[-1]
    if t.kind in ("num", "str", "ident", "regex"):
        return False
    if t.kind == "keyword":
        return t.value not in ("this", "null", "true", "false",
                               "undefined")
    return t.value not in (")", "]", "}", "++", "--")

"""JavaScript (ES5 subset) recursive-descent parser.

Produces a lightweight tuple AST consumed by interp.py. Function
nodes carry their source text span so functions can be re-serialized
for plan shipping (the reference serializes closures via String(fn),
prelude.js-style; our runtime does the same with the recorded span).

Automatic semicolon insertion is implemented pragmatically: a missing
';' is accepted at '}' / EOF / a line break, and `return`/`throw`/
`break`/`continue` bind only to same-line expressions.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from eventql_tpu_torch.mapreduce.js.lexer import JSSyntaxError, Token, tokenize

ASSIGN_OPS = {"=", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=",
              "<<=", ">>=", ">>>="}

# binary operator precedence (higher binds tighter)
BIN_PREC = {
    "||": 1, "&&": 2,
    "|": 3, "^": 4, "&": 5,
    "==": 6, "!=": 6, "===": 6, "!==": 6,
    "<": 7, ">": 7, "<=": 7, ">=": 7, "instanceof": 7, "in": 7,
    "<<": 8, ">>": 8, ">>>": 8,
    "+": 9, "-": 9,
    "*": 10, "/": 10, "%": 10,
}


class Parser:
    def __init__(self, src: str):
        self.src = src
        self.toks: List[Token] = tokenize(src)
        self.i = 0
        self.no_in = 0  # suppress the `in` operator inside for-heads

    # -- token helpers ---------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if self.i < len(self.toks) - 1:
            self.i += 1
        return t

    def at(self, value: str, kind: str = None) -> bool:
        t = self.peek()
        return t.value == value and (kind is None or t.kind == kind)

    def eat(self, value: str) -> bool:
        if self.peek().value == value and self.peek().kind in (
                "punct", "keyword"):
            self.next()
            return True
        return False

    def expect(self, value: str) -> Token:
        t = self.peek()
        if t.value != value or t.kind not in ("punct", "keyword"):
            raise JSSyntaxError(
                f"expected {value!r} but got {t.value!r} (line {t.line})")
        return self.next()

    def semicolon(self):
        """Consume ';' with ASI at '}' / EOF / line break."""
        t = self.peek()
        if t.value == ";" and t.kind == "punct":
            self.next()
            return
        if t.kind == "eof" or (t.value == "}" and t.kind == "punct"):
            return
        prev = self.toks[self.i - 1] if self.i > 0 else t
        if t.line > prev.line:
            return
        raise JSSyntaxError(
            f"expected ';' but got {t.value!r} (line {t.line})")

    # -- program ----------------------------------------------------------
    def parse_program(self) -> list:
        stmts = []
        while self.peek().kind != "eof":
            stmts.append(self.statement())
        return stmts

    # -- statements --------------------------------------------------------
    def statement(self):
        t = self.peek()
        if t.kind == "punct":
            if t.value == "{":
                return self.block()
            if t.value == ";":
                self.next()
                return ("empty",)
        if t.kind == "keyword":
            v = t.value
            if v == "var":
                s = self.var_statement()
                self.semicolon()
                return s
            if v == "function":
                return self.function_literal(declaration=True)
            if v == "if":
                return self.if_statement()
            if v == "for":
                return self.for_statement()
            if v == "while":
                self.next()
                self.expect("(")
                test = self.expression()
                self.expect(")")
                return ("while", test, self.statement())
            if v == "do":
                self.next()
                body = self.statement()
                self.expect("while")
                self.expect("(")
                test = self.expression()
                self.expect(")")
                self.semicolon()
                return ("dowhile", body, test)
            if v == "return":
                self.next()
                nt = self.peek()
                if (nt.value in (";", "}") and nt.kind == "punct") \
                        or nt.kind == "eof" or nt.line > t.line:
                    self.semicolon()
                    return ("return", None)
                e = self.expression()
                self.semicolon()
                return ("return", e)
            if v == "break":
                self.next()
                nt = self.peek()
                if nt.kind == "ident" and nt.line == t.line:
                    self.next()
                    self.semicolon()
                    return ("break", nt.value)
                self.semicolon()
                return ("break", None)
            if v == "continue":
                self.next()
                nt = self.peek()
                if nt.kind == "ident" and nt.line == t.line:
                    self.next()
                    self.semicolon()
                    return ("continue", nt.value)
                self.semicolon()
                return ("continue", None)
            if v == "throw":
                self.next()
                e = self.expression()
                self.semicolon()
                return ("throw", e)
            if v == "try":
                return self.try_statement()
            if v == "switch":
                return self.switch_statement()
            if v in ("class", "const", "let", "with", "yield"):
                raise JSSyntaxError(
                    f"'{v}' is not supported (line {t.line})")
        if t.kind == "ident":
            nt = self.peek(1)
            if nt is not None and nt.kind == "punct" and nt.value == ":":
                self.next()
                self.next()
                return ("label", t.value, self.statement())
        e = self.expression()
        self.semicolon()
        return ("expr", e)

    def block(self):
        self.expect("{")
        stmts = []
        while not self.at("}"):
            if self.peek().kind == "eof":
                raise JSSyntaxError("unexpected end of input in block")
            stmts.append(self.statement())
        self.expect("}")
        return ("block", stmts)

    def var_statement(self):
        self.expect("var")
        decls = []
        while True:
            name = self.ident_name()
            init = None
            if self.eat("="):
                init = self.assignment()
            decls.append((name, init))
            if not self.eat(","):
                break
        return ("var", decls)

    def ident_name(self) -> str:
        t = self.peek()
        if t.kind == "ident":
            self.next()
            return t.value
        if t.kind == "keyword" and t.value == "undefined":
            self.next()
            return t.value
        raise JSSyntaxError(
            f"expected identifier, got {t.value!r} (line {t.line})")

    def if_statement(self):
        self.expect("if")
        self.expect("(")
        test = self.expression()
        self.expect(")")
        cons = self.statement()
        alt = None
        if self.eat("else"):
            alt = self.statement()
        return ("if", test, cons, alt)

    def for_statement(self):
        self.expect("for")
        self.expect("(")
        init = None
        if self.at("var", "keyword"):
            self.no_in += 1
            init = self.var_statement()
            self.no_in -= 1
            # for (var k in obj)
            if self.at("in", "keyword") and len(init[1]) == 1 \
                    and init[1][0][1] is None:
                self.next()
                obj = self.expression()
                self.expect(")")
                return ("forin", ("var", init[1][0][0]), obj,
                        self.statement())
        elif not self.at(";"):
            self.no_in += 1
            first = self.expression()
            self.no_in -= 1
            if self.at("in", "keyword"):
                self.next()
                obj = self.expression()
                self.expect(")")
                return ("forin", ("target", first), obj, self.statement())
            init = ("expr", first)
        self.expect(";")
        test = None if self.at(";") else self.expression()
        self.expect(";")
        update = None if self.at(")") else self.expression()
        self.expect(")")
        return ("for", init, test, update, self.statement())

    def try_statement(self):
        self.expect("try")
        block = self.block()
        catch_param = catch_block = finally_block = None
        if self.eat("catch"):
            self.expect("(")
            catch_param = self.ident_name()
            self.expect(")")
            catch_block = self.block()
        if self.eat("finally"):
            finally_block = self.block()
        if catch_block is None and finally_block is None:
            raise JSSyntaxError("try without catch or finally")
        return ("try", block, catch_param, catch_block, finally_block)

    def switch_statement(self):
        self.expect("switch")
        self.expect("(")
        disc = self.expression()
        self.expect(")")
        self.expect("{")
        cases = []
        while not self.at("}"):
            if self.eat("case"):
                test = self.expression()
            else:
                self.expect("default")
                test = None
            self.expect(":")
            stmts = []
            while not (self.at("case", "keyword")
                       or self.at("default", "keyword") or self.at("}")):
                stmts.append(self.statement())
            cases.append((test, stmts))
        self.expect("}")
        return ("switch", disc, cases)

    # -- expressions ---------------------------------------------------
    def expression(self):
        e = self.assignment()
        if self.at(","):
            exprs = [e]
            while self.eat(","):
                exprs.append(self.assignment())
            return ("seq", exprs)
        return e

    def assignment(self):
        left = self.conditional()
        t = self.peek()
        if t.kind == "punct" and t.value in ASSIGN_OPS:
            if left[0] not in ("ident", "member", "index"):
                raise JSSyntaxError(
                    f"invalid assignment target (line {t.line})")
            self.next()
            right = self.assignment()
            return ("assign", t.value, left, right)
        return left

    def conditional(self):
        test = self.binary(0)
        if self.eat("?"):
            cons = self.assignment()
            self.expect(":")
            alt = self.assignment()
            return ("cond", test, cons, alt)
        return test

    def binary(self, min_prec: int):
        left = self.unary()
        while True:
            t = self.peek()
            op = t.value
            if t.kind not in ("punct", "keyword") or op not in BIN_PREC:
                return left
            if op == "in" and self.no_in:
                return left
            prec = BIN_PREC[op]
            if prec < min_prec:
                return left
            self.next()
            right = self.binary(prec + 1)
            kind = "logic" if op in ("&&", "||") else "bin"
            left = (kind, op, left, right)

    def unary(self):
        t = self.peek()
        if t.kind == "punct" and t.value in ("!", "~", "+", "-"):
            self.next()
            return ("un", t.value, self.unary())
        if t.kind == "punct" and t.value in ("++", "--"):
            self.next()
            target = self.unary()
            return ("update", t.value, target, True)
        if t.kind == "keyword" and t.value in ("typeof", "void", "delete"):
            self.next()
            return ("un", t.value, self.unary())
        return self.postfix()

    def postfix(self):
        e = self.call_member(self.primary())
        t = self.peek()
        if t.kind == "punct" and t.value in ("++", "--") \
                and t.line == self.toks[self.i - 1].line:
            self.next()
            return ("update", t.value, e, False)
        return e

    def call_member(self, e):
        while True:
            if self.eat("."):
                e = ("member", e, self.property_name())
            elif self.at("["):
                self.next()
                idx = self.expression()
                self.expect("]")
                e = ("index", e, idx)
            elif self.at("("):
                e = ("call", e, self.arguments())
            else:
                return e

    def property_name(self) -> str:
        t = self.peek()
        if t.kind in ("ident", "keyword"):
            self.next()
            return t.value
        raise JSSyntaxError(
            f"expected property name, got {t.value!r} (line {t.line})")

    def arguments(self) -> list:
        self.expect("(")
        args = []
        if not self.at(")"):
            args.append(self.assignment())
            while self.eat(","):
                args.append(self.assignment())
        self.expect(")")
        return args

    def primary(self):
        t = self.peek()
        if t.kind == "num":
            self.next()
            v = t.value
            if v.lower().startswith("0x"):
                return ("num", float(int(v, 16)))
            return ("num", float(v))
        if t.kind == "str":
            self.next()
            return ("str", t.value)
        if t.kind == "regex":
            self.next()
            body = t.value
            end = body.rindex("/")
            return ("regex", body[1:end], body[end + 1:])
        if t.kind == "ident":
            self.next()
            return ("ident", t.value)
        if t.kind == "keyword":
            v = t.value
            if v == "true" or v == "false":
                self.next()
                return ("bool", v == "true")
            if v == "null":
                self.next()
                return ("null",)
            if v == "undefined":
                self.next()
                return ("undef",)
            if v == "this":
                self.next()
                return ("this",)
            if v == "function":
                return self.function_literal(declaration=False)
            if v == "new":
                self.next()
                callee = self.primary()
                # member chain before the call parens
                while True:
                    if self.eat("."):
                        callee = ("member", callee, self.property_name())
                    elif self.at("["):
                        self.next()
                        idx = self.expression()
                        self.expect("]")
                        callee = ("index", callee, idx)
                    else:
                        break
                args = self.arguments() if self.at("(") else []
                return ("new", callee, args)
        if t.kind == "punct":
            if t.value == "(":
                self.next()
                e = self.expression()
                self.expect(")")
                return e
            if t.value == "[":
                return self.array_literal()
            if t.value == "{":
                return self.object_literal()
        raise JSSyntaxError(
            f"unexpected token {t.value!r} (line {t.line})")

    def array_literal(self):
        self.expect("[")
        elems = []
        while not self.at("]"):
            if self.at(","):
                self.next()
                elems.append(("undef",))
                continue
            elems.append(self.assignment())
            if not self.at("]"):
                self.expect(",")
        self.expect("]")
        return ("array", elems)

    def object_literal(self):
        self.expect("{")
        props = []
        while not self.at("}"):
            t = self.peek()
            if t.kind in ("ident", "keyword"):
                key = t.value
                self.next()
                if key in ("get", "set") and not self.at(":") \
                        and not self.at(",") and not self.at("}"):
                    # accessor property: get name() {..} / set name(v) {..}
                    # (ES5 11.1.5 PropertyAssignment)
                    kind = key
                    nt = self.peek()
                    if nt.kind in ("ident", "keyword", "str"):
                        key = nt.value
                        self.next()
                    elif nt.kind == "num":
                        key = _num_key(nt.value)
                        self.next()
                    else:
                        raise JSSyntaxError(
                            f"bad accessor name {nt.value!r} "
                            f"(line {nt.line})")
                    start_tok = self.peek()
                    self.expect("(")
                    params = []
                    if not self.at(")"):
                        params.append(self.ident_name())
                        while self.eat(","):
                            params.append(self.ident_name())
                    self.expect(")")
                    body = self.block()
                    end_pos = self.toks[self.i - 1].pos + 1
                    fn = ("func", None, params, body[1],
                          self.src[start_tok.pos:end_pos])
                    props.append((key, fn, kind))
                    if not self.at("}"):
                        self.expect(",")
                    continue
            elif t.kind == "str":
                key = t.value
                self.next()
            elif t.kind == "num":
                key = _num_key(t.value)
                self.next()
            else:
                raise JSSyntaxError(
                    f"bad object key {t.value!r} (line {t.line})")
            self.expect(":")
            props.append((key, self.assignment(), "init"))
            if not self.at("}"):
                self.expect(",")
        self.expect("}")
        return ("object", props)

    def function_literal(self, declaration: bool):
        start_tok = self.peek()
        self.expect("function")
        name = None
        if self.peek().kind == "ident":
            name = self.next().value
        elif declaration:
            raise JSSyntaxError(
                f"function declaration needs a name "
                f"(line {start_tok.line})")
        self.expect("(")
        params = []
        if not self.at(")"):
            params.append(self.ident_name())
            while self.eat(","):
                params.append(self.ident_name())
        self.expect(")")
        body = self.block()
        end_pos = self.toks[self.i - 1].pos + 1  # past the closing '}'
        src_text = self.src[start_tok.pos:end_pos]
        node = ("func", name, params, body[1], src_text)
        return ("fndecl",) + node[1:] if declaration else node


def _num_key(v: str) -> str:
    f = float(int(v, 16)) if v.lower().startswith("0x") else float(v)
    return str(int(f)) if f == int(f) else repr(f)


def parse(src: str) -> list:
    return Parser(src).parse_program()


def parse_function_expression(src: str):
    """Parse a standalone `function (...) {...}` source string (the
    plan-shipping wire form) into a func node."""
    p = Parser("(" + src + ")")
    e = p.expression()
    if p.peek().kind != "eof":
        raise JSSyntaxError("trailing input after function expression")
    if e[0] != "func":
        raise JSSyntaxError("not a function expression")
    return e

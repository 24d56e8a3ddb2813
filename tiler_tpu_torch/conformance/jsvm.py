"""Minimal ECMAScript interpreter: runs the reference GTM decoder verbatim.

No JS engine ships in this environment, but BASELINE.md demands output
"bit-playable by the unchanged gtm.player.js". This module implements the
ES5-and-a-bit subset those files use (prototypes, closures, typed arrays,
switch, try/catch, let/const, Promise/Worker glue) so the conformance
harness (player.py) can execute /root/reference/decoders/htmljs/*.js
WITHOUT modification and compare pixels against our own decoder.

Scope is deliberately the reference decoder's feature set, verified by the
conformance tests — this is a test oracle, not a general JS runtime.

Structure: regex tokenizer -> recursive-descent parser (tuple AST) ->
compile-to-Python-closures evaluator (fast enough to LZMA-unpack and
paint small streams in CI).
"""
from __future__ import annotations

import math
import re


# ---------------------------------------------------------------------------
# values
# ---------------------------------------------------------------------------

class JSUndefined:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "undefined"

    def __bool__(self):
        return False


UNDEF = JSUndefined()
NULL = None  # JS null is Python None


class JSObject:
    __slots__ = ("props", "proto", "cls")

    def __init__(self, proto=None, cls="Object"):
        self.props = {}
        self.proto = proto
        self.cls = cls

    def get(self, key):
        o = self
        while o is not None:
            v = o.props.get(key, _MISSING)
            if v is not _MISSING:
                return v
            o = o.proto
        return UNDEF

    def set(self, key, val):
        self.props[key] = val


_MISSING = object()


class JSFunction(JSObject):
    __slots__ = ("name", "params", "body", "env", "source", "vars", "funcs")

    def __init__(self, name, params, body, env, source, hoist):
        super().__init__(cls="Function")
        self.name = name
        self.params = params
        self.body = body  # compiled stmt list executor
        self.env = env
        self.source = source
        self.vars, self.funcs = hoist  # hoisted var names, fundecl thunks

    def prototype(self):
        p = self.props.get("prototype", _MISSING)
        if p is _MISSING:
            p = JSObject()
            p.props["constructor"] = self
            self.props["prototype"] = p
        return p


class NativeFunction(JSObject):
    __slots__ = ("name", "fn", "ctor")

    def __init__(self, name, fn, ctor=None):
        super().__init__(cls="Function")
        self.name = name
        self.fn = fn  # fn(this, args) -> value
        self.ctor = ctor  # ctor(args) -> object, for `new`


class JSArray:
    __slots__ = ("items",)

    def __init__(self, items=None):
        self.items = items if items is not None else []


class JSArrayBuffer:
    __slots__ = ("data",)

    def __init__(self, data):
        self.data = data  # bytearray


class JSTypedArray:
    __slots__ = ("data", "clamped")

    def __init__(self, data, clamped=False):
        self.data = data  # bytearray (shared with an ArrayBuffer)
        self.clamped = clamped


class JSError(Exception):
    """A JS `throw` propagating through the interpreter."""

    def __init__(self, value):
        self.value = value
        super().__init__(js_str(value) if not isinstance(value, JSObject) else "")


class _Return(Exception):
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


_BREAK = _Break()
_CONT = _Continue()


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

_PUNCTS = [
    ">>>=", "===", "!==", ">>>", "<<=", ">>=", "==", "!=", "<=", ">=", "&&",
    "||", "++", "--", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=", "<<",
    ">>", "{", "}", "(", ")", "[", "]", ";", ",", "<", ">", "+", "-", "*",
    "/", "%", "&", "|", "^", "!", "~", "?", ":", "=", ".",
]
_PUNCT_RE = "|".join(re.escape(p) for p in _PUNCTS)
_TOKEN_RE = re.compile(
    r"""
    (?P<ws>[ \t\r]+)
  | (?P<nl>\n)
  | (?P<lcomment>//[^\n]*)
  | (?P<bcomment>/\*.*?\*/)
  | (?P<num>0[xX][0-9a-fA-F]+|(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_$][A-Za-z0-9_$]*)
  | (?P<str>'(?:\\.|[^'\\])*'|"(?:\\.|[^"\\])*")
  | (?P<punct>""" + _PUNCT_RE + r""")
    """,
    re.VERBOSE | re.DOTALL,
)

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "b": "\b", "f": "\f", "v": "\v", "0": "\0"}


def _unescape(s):
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            n = s[i + 1]
            if n in _ESCAPES:
                out.append(_ESCAPES[n])
                i += 2
            elif n == "x":
                out.append(chr(int(s[i + 2 : i + 4], 16)))
                i += 4
            elif n == "u":
                out.append(chr(int(s[i + 2 : i + 6], 16)))
                i += 6
            else:
                out.append(n)
                i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


class Token:
    __slots__ = ("kind", "value", "pos", "nl")

    def __init__(self, kind, value, pos, nl):
        self.kind = kind
        self.value = value
        self.pos = pos
        self.nl = nl  # newline before this token


def tokenize(src):
    toks = []
    pos = 0
    nl = False
    n = len(src)
    while pos < n:
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise SyntaxError(f"jsvm: bad token at {pos}: {src[pos:pos+30]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        if kind == "nl":
            nl = True
            continue
        if kind in ("lcomment", "bcomment"):
            if "\n" in m.group(0):
                nl = True
            continue
        v = m.group(0)
        if kind == "num":
            v = float(int(v, 16)) if v[:2] in ("0x", "0X") else float(v)
            if v.is_integer() and abs(v) < 2**53:
                v = int(v)
        elif kind == "str":
            v = _unescape(v[1:-1])
        toks.append(Token(kind, v, m.start(), nl))
        nl = False
    toks.append(Token("eof", None, n, True))
    return toks


# ---------------------------------------------------------------------------
# parser -> tuple AST
# ---------------------------------------------------------------------------

_KEYWORDS = {
    "var", "let", "const", "function", "return", "if", "else", "for",
    "while", "do", "switch", "case", "default", "break", "continue", "new",
    "typeof", "instanceof", "in", "this", "null", "undefined", "true",
    "false", "throw", "try", "catch", "finally", "delete", "void",
    "debugger",
}


class Parser:
    def __init__(self, src):
        self.src = src
        self.toks = tokenize(src)
        self.i = 0

    # --- token helpers ---
    def peek(self, off=0):
        return self.toks[self.i + off]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_punct(self, p):
        t = self.peek()
        return t.kind == "punct" and t.value == p

    def at_name(self, w):
        t = self.peek()
        return t.kind == "name" and t.value == w

    def eat_punct(self, p):
        if not self.at_punct(p):
            t = self.peek()
            raise SyntaxError(f"jsvm: expected {p!r} at {t.pos}, got {t.value!r}")
        return self.next()

    def eat_name(self, w=None):
        t = self.next()
        if t.kind != "name" or (w is not None and t.value != w):
            raise SyntaxError(f"jsvm: expected name {w!r} at {t.pos}, got {t.value!r}")
        return t.value

    def semi(self):
        """Consume a statement terminator with simplified ASI."""
        t = self.peek()
        if t.kind == "punct" and t.value == ";":
            self.next()
        elif t.kind == "eof" or (t.kind == "punct" and t.value == "}") or t.nl:
            pass
        else:
            raise SyntaxError(f"jsvm: expected ; at {t.pos}, got {t.value!r}")

    # --- program / statements ---
    def parse_program(self):
        stmts = []
        while self.peek().kind != "eof":
            stmts.append(self.statement())
        return ("block", stmts)

    def statement(self):
        t = self.peek()
        if t.kind == "punct":
            if t.value == "{":
                return self.block()
            if t.value == ";":
                self.next()
                return ("empty",)
        if t.kind == "name":
            w = t.value
            if w in ("var", "let", "const"):
                self.next()
                d = self.var_decls()
                self.semi()
                return ("var", w, d)
            if w == "function":
                self.next()
                name = self.eat_name()
                fn = self.function_rest(name, t.pos)
                return ("fundecl", name, fn)
            if w == "if":
                self.next()
                self.eat_punct("(")
                c = self.expression()
                self.eat_punct(")")
                a = self.statement()
                b = None
                if self.at_name("else"):
                    self.next()
                    b = self.statement()
                return ("if", c, a, b)
            if w == "while":
                self.next()
                self.eat_punct("(")
                c = self.expression()
                self.eat_punct(")")
                return ("while", c, self.statement())
            if w == "do":
                self.next()
                body = self.statement()
                self.eat_name("while")
                self.eat_punct("(")
                c = self.expression()
                self.eat_punct(")")
                self.semi()
                return ("dowhile", body, c)
            if w == "for":
                return self.for_stmt()
            if w == "return":
                self.next()
                t2 = self.peek()
                if (t2.kind == "punct" and t2.value in (";", "}")) or t2.nl or t2.kind == "eof":
                    e = None
                else:
                    e = self.expression()
                self.semi()
                return ("return", e)
            if w == "break":
                self.next()
                self.semi()
                return ("break",)
            if w == "continue":
                self.next()
                self.semi()
                return ("continue",)
            if w == "switch":
                self.next()
                self.eat_punct("(")
                disc = self.expression()
                self.eat_punct(")")
                self.eat_punct("{")
                cases = []
                while not self.at_punct("}"):
                    if self.at_name("case"):
                        self.next()
                        test = self.expression()
                        self.eat_punct(":")
                    else:
                        self.eat_name("default")
                        self.eat_punct(":")
                        test = None
                    body = []
                    while not (
                        self.at_punct("}") or self.at_name("case") or self.at_name("default")
                    ):
                        body.append(self.statement())
                    cases.append((test, body))
                self.eat_punct("}")
                return ("switch", disc, cases)
            if w == "throw":
                self.next()
                e = self.expression()
                self.semi()
                return ("throw", e)
            if w == "try":
                self.next()
                block = self.block()
                param = None
                catch = None
                fin = None
                if self.at_name("catch"):
                    self.next()
                    if self.at_punct("("):
                        self.next()
                        param = self.eat_name()
                        self.eat_punct(")")
                    catch = self.block()
                if self.at_name("finally"):
                    self.next()
                    fin = self.block()
                return ("try", block, param, catch, fin)
            if w == "debugger":
                self.next()
                self.semi()
                return ("empty",)
        e = self.expression()
        self.semi()
        return ("expr", e)

    def block(self):
        self.eat_punct("{")
        stmts = []
        while not self.at_punct("}"):
            stmts.append(self.statement())
        self.next()
        return ("block", stmts)

    def var_decls(self):
        decls = []
        while True:
            name = self.eat_name()
            init = None
            if self.at_punct("="):
                self.next()
                init = self.assignment()
            decls.append((name, init))
            if self.at_punct(","):
                self.next()
                continue
            return decls

    def for_stmt(self):
        self.eat_name("for")
        self.eat_punct("(")
        init = None
        if self.at_punct(";"):
            self.next()
        elif self.peek().kind == "name" and self.peek().value in ("var", "let", "const"):
            kind = self.next().value
            init = ("var", kind, self.var_decls())
            self.eat_punct(";")
        else:
            init = ("expr", self.expression())
            self.eat_punct(";")
        cond = None if self.at_punct(";") else self.expression()
        self.eat_punct(";")
        upd = None if self.at_punct(")") else self.expression()
        self.eat_punct(")")
        return ("for", init, cond, upd, self.statement())

    def function_rest(self, name, start_pos):
        self.eat_punct("(")
        params = []
        while not self.at_punct(")"):
            params.append(self.eat_name())
            if self.at_punct(","):
                self.next()
        self.next()
        body = self.block()
        end_pos = self.toks[self.i - 1].pos + 1
        return ("func", name, params, body, (start_pos, end_pos))

    # --- expressions ---
    def expression(self):
        e = self.assignment()
        if self.at_punct(","):
            parts = [e]
            while self.at_punct(","):
                self.next()
                parts.append(self.assignment())
            return ("seq", parts)
        return e

    _ASSIGN_OPS = {"=", "+=", "-=", "*=", "/=", "%=", "<<=", ">>=", ">>>=", "&=", "|=", "^="}

    def assignment(self):
        left = self.conditional()
        t = self.peek()
        if t.kind == "punct" and t.value in self._ASSIGN_OPS:
            self.next()
            if left[0] not in ("name", "member", "index"):
                raise SyntaxError(f"jsvm: bad assignment target at {t.pos}")
            right = self.assignment()
            return ("assign", t.value, left, right)
        return left

    def conditional(self):
        c = self.logical_or()
        if self.at_punct("?"):
            self.next()
            a = self.assignment()
            self.eat_punct(":")
            b = self.assignment()
            return ("cond", c, a, b)
        return c

    def _binlevel(self, sub, ops, node="binop"):
        e = sub()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.value in ops:
                self.next()
                e = (node, t.value, e, sub())
            elif t.kind == "name" and t.value in ops:
                self.next()
                e = (node, t.value, e, sub())
            else:
                return e

    def logical_or(self):
        return self._binlevel(self.logical_and, ("||",), "logic")

    def logical_and(self):
        return self._binlevel(self.bit_or, ("&&",), "logic")

    def bit_or(self):
        return self._binlevel(self.bit_xor, ("|",))

    def bit_xor(self):
        return self._binlevel(self.bit_and, ("^",))

    def bit_and(self):
        return self._binlevel(self.equality, ("&",))

    def equality(self):
        return self._binlevel(self.relational, ("==", "!=", "===", "!=="))

    def relational(self):
        return self._binlevel(self.shift, ("<", ">", "<=", ">=", "instanceof", "in"))

    def shift(self):
        return self._binlevel(self.additive, ("<<", ">>", ">>>"))

    def additive(self):
        return self._binlevel(self.multiplicative, ("+", "-"))

    def multiplicative(self):
        return self._binlevel(self.unary, ("*", "/", "%"))

    def unary(self):
        t = self.peek()
        if t.kind == "punct" and t.value in ("!", "~", "+", "-"):
            self.next()
            return ("unary", t.value, self.unary())
        if t.kind == "punct" and t.value in ("++", "--"):
            self.next()
            return ("update", t.value, True, self.unary())
        if t.kind == "name" and t.value in ("typeof", "delete", "void"):
            self.next()
            return ("unary", t.value, self.unary())
        return self.postfix()

    def postfix(self):
        e = self.call_member(self.primary())
        t = self.peek()
        if t.kind == "punct" and t.value in ("++", "--") and not t.nl:
            self.next()
            return ("update", t.value, False, e)
        return e

    def call_member(self, e):
        while True:
            if self.at_punct("."):
                self.next()
                e = ("member", e, self.eat_name())
            elif self.at_punct("["):
                self.next()
                k = self.expression()
                self.eat_punct("]")
                e = ("index", e, k)
            elif self.at_punct("("):
                e = ("call", e, self.args())
            else:
                return e

    def args(self):
        self.eat_punct("(")
        out = []
        while not self.at_punct(")"):
            out.append(self.assignment())
            if self.at_punct(","):
                self.next()
        self.next()
        return out

    def primary(self):
        t = self.next()
        if t.kind == "num":
            return ("num", t.value)
        if t.kind == "str":
            return ("str", t.value)
        if t.kind == "name":
            w = t.value
            if w == "this":
                return ("this",)
            if w == "null":
                return ("null",)
            if w == "undefined":
                return ("undef",)
            if w == "true":
                return ("bool", True)
            if w == "false":
                return ("bool", False)
            if w == "function":
                name = None
                if self.peek().kind == "name":
                    name = self.eat_name()
                return self.function_rest(name, t.pos)
            if w == "new":
                callee = self.call_member_no_call(self.primary())
                args = self.args() if self.at_punct("(") else []
                return self.call_member_tail(("new", callee, args))
            return ("name", w)
        if t.kind == "punct":
            if t.value == "(":
                e = self.expression()
                self.eat_punct(")")
                return e
            if t.value == "[":
                elems = []
                while not self.at_punct("]"):
                    elems.append(self.assignment())
                    if self.at_punct(","):
                        self.next()
                self.next()
                return ("arr", elems)
            if t.value == "{":
                props = []
                while not self.at_punct("}"):
                    kt = self.next()
                    if kt.kind in ("name", "str"):
                        key = str(kt.value)
                    elif kt.kind == "num":
                        key = js_str(kt.value)
                    else:
                        raise SyntaxError(f"jsvm: bad object key at {kt.pos}")
                    self.eat_punct(":")
                    props.append((key, self.assignment()))
                    if self.at_punct(","):
                        self.next()
                self.next()
                return ("obj", props)
        raise SyntaxError(f"jsvm: unexpected token {t.value!r} at {t.pos}")

    def call_member_no_call(self, e):
        """Member chain without call — `new a.b.C(args)` binds args to C."""
        while True:
            if self.at_punct("."):
                self.next()
                e = ("member", e, self.eat_name())
            elif self.at_punct("["):
                self.next()
                k = self.expression()
                self.eat_punct("]")
                e = ("index", e, k)
            else:
                return e

    def call_member_tail(self, e):
        t = self.peek()
        if t.kind == "punct" and t.value in (".", "[", "("):
            return self.call_member(e)
        return e


# ---------------------------------------------------------------------------
# number / coercion helpers
# ---------------------------------------------------------------------------

def js_truthy(v):
    if v is UNDEF or v is None or v is False:
        return False
    if v is True:
        return True
    if isinstance(v, (int, float)):
        return v != 0 and v == v
    if isinstance(v, str):
        return v != ""
    return True


def js_tonumber(v):
    if isinstance(v, bool):
        return 1 if v else 0
    if isinstance(v, (int, float)):
        return v
    if v is None:
        return 0
    if v is UNDEF:
        return math.nan
    if isinstance(v, str):
        s = v.strip()
        if s == "":
            return 0
        try:
            if s[:2] in ("0x", "0X"):
                return int(s, 16)
            f = float(s)
            return int(f) if f.is_integer() and abs(f) < 2**53 else f
        except ValueError:
            return math.nan
    return math.nan


def to_int32(v):
    n = js_tonumber(v)
    if isinstance(n, float):
        if n != n or n in (math.inf, -math.inf):
            return 0
        n = int(n)
    n &= 0xFFFFFFFF
    return n - 0x100000000 if n >= 0x80000000 else n


def to_uint32(v):
    n = js_tonumber(v)
    if isinstance(n, float):
        if n != n or n in (math.inf, -math.inf):
            return 0
        n = int(n)
    return n & 0xFFFFFFFF


def js_str(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is UNDEF:
        return "undefined"
    if v is None:
        return "null"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return "NaN"
        if v == math.inf:
            return "Infinity"
        if v == -math.inf:
            return "-Infinity"
        if v.is_integer() and abs(v) < 1e21:
            return str(int(v))
        return repr(v)
    if isinstance(v, str):
        return v
    if isinstance(v, JSArray):
        return ",".join("" if x is UNDEF or x is None else js_str(x) for x in v.items)
    if isinstance(v, (JSFunction, NativeFunction)):
        src = getattr(v, "source", None)
        return src if isinstance(src, str) else f"function {getattr(v, 'name', '')}() {{ [native code] }}"
    if isinstance(v, JSObject):
        ts = v.get("toString")
        if callable(getattr(ts, "fn", None)) or isinstance(ts, JSFunction):
            return js_str(_CURRENT[0].call_function(ts, [], this=v))
        return "[object Object]"
    if isinstance(v, JSTypedArray):
        return ",".join(str(b) for b in v.data)
    return str(v)


def js_eq_strict(a, b):
    if a is UNDEF:
        return b is UNDEF
    if a is None:
        return b is None
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a == b
    if isinstance(a, str) and isinstance(b, str):
        return a == b
    return a is b


def js_eq_loose(a, b):
    if (a is UNDEF or a is None) and (b is UNDEF or b is None):
        return True
    if a is UNDEF or a is None or b is UNDEF or b is None:
        return False
    an = isinstance(a, (int, float, bool))
    bn = isinstance(b, (int, float, bool))
    if an and bn:
        return js_tonumber(a) == js_tonumber(b)
    if isinstance(a, str) and isinstance(b, str):
        return a == b
    if an and isinstance(b, str):
        return js_tonumber(a) == js_tonumber(b)
    if isinstance(a, str) and bn:
        return js_tonumber(a) == js_tonumber(b)
    return a is b


# the running interpreter (for js_str object toString dispatch)
_CURRENT = [None]


# ---------------------------------------------------------------------------
# environment
# ---------------------------------------------------------------------------

class Env:
    __slots__ = ("vars", "parent")

    def __init__(self, parent=None, vars=None):
        self.vars = vars if vars is not None else {}
        self.parent = parent


# ---------------------------------------------------------------------------
# compiler: AST -> closures
# ---------------------------------------------------------------------------

def _hoist(node, vars_out, funcs_out):
    """Collect var names + function declarations, not descending into funcs."""
    t = node[0]
    if t == "var":
        if node[1] == "var":
            for name, _ in node[2]:
                vars_out.append(name)
        return
    if t == "fundecl":
        funcs_out.append((node[1], node[2]))
        return
    if t == "block":
        for s in node[1]:
            _hoist(s, vars_out, funcs_out)
    elif t == "if":
        _hoist(node[2], vars_out, funcs_out)
        if node[3] is not None:
            _hoist(node[3], vars_out, funcs_out)
    elif t in ("while",):
        _hoist(node[2], vars_out, funcs_out)
    elif t == "dowhile":
        _hoist(node[1], vars_out, funcs_out)
    elif t == "for":
        if node[1] is not None:
            _hoist(node[1], vars_out, funcs_out)
        _hoist(node[4], vars_out, funcs_out)
    elif t == "switch":
        for _, body in node[2]:
            for s in body:
                _hoist(s, vars_out, funcs_out)
    elif t == "try":
        _hoist(node[1], vars_out, funcs_out)
        if node[3] is not None:
            _hoist(node[3], vars_out, funcs_out)
        if node[4] is not None:
            _hoist(node[4], vars_out, funcs_out)


class Compiler:
    def __init__(self, interp, src):
        self.interp = interp
        self.src = src

    # --- expressions ---
    def expr(self, node):
        t = node[0]
        m = getattr(self, "e_" + t)
        return m(node)

    def e_num(self, n):
        v = n[1]
        return lambda env: v

    def e_str(self, n):
        v = n[1]
        return lambda env: v

    def e_bool(self, n):
        v = n[1]
        return lambda env: v

    def e_null(self, n):
        return lambda env: None

    def e_undef(self, n):
        return lambda env: UNDEF

    def e_this(self, n):
        def run(env):
            e = env
            while e is not None:
                v = e.vars.get("this", _MISSING)
                if v is not _MISSING:
                    return v
                e = e.parent
            return UNDEF
        return run

    def e_name(self, n):
        name = n[1]
        interp = self.interp

        def run(env):
            e = env
            while e is not None:
                v = e.vars.get(name, _MISSING)
                if v is not _MISSING:
                    return v
                e = e.parent
            raise JSError(interp.make_error("ReferenceError", name + " is not defined"))
        return run

    def e_seq(self, n):
        parts = [self.expr(p) for p in n[1]]

        def run(env):
            v = UNDEF
            for p in parts:
                v = p(env)
            return v
        return run

    def e_arr(self, n):
        elems = [self.expr(e) for e in n[1]]
        return lambda env: JSArray([e(env) for e in elems])

    def e_obj(self, n):
        props = [(k, self.expr(v)) for k, v in n[1]]

        def run(env):
            o = JSObject()
            for k, v in props:
                o.props[k] = v(env)
            return o
        return run

    def e_func(self, n):
        _, name, params, body, span = n
        source = self.src[span[0] : span[1]]
        vars_out, funcs_out = [], []
        for s in body[1]:
            _hoist(s, vars_out, funcs_out)
        cbody = self.stmt(body)
        cfuncs = [(fname, self.expr(fnode)) for fname, fnode in funcs_out]

        def run(env):
            return JSFunction(name, params, cbody, env, source, (vars_out, cfuncs))
        return run

    def e_call(self, n):
        _, callee, argnodes = n
        cargs = [self.expr(a) for a in argnodes]
        interp = self.interp
        if callee[0] == "member":
            cobj = self.expr(callee[1])
            key = callee[2]

            def run(env):
                this = cobj(env)
                f = interp.get_prop(this, key)
                return interp.call_function(f, [a(env) for a in cargs], this=this, name=key)
            return run
        if callee[0] == "index":
            cobj = self.expr(callee[1])
            ckey = self.expr(callee[2])

            def run(env):
                this = cobj(env)
                f = interp.get_prop(this, interp.prop_key(ckey(env)))
                return interp.call_function(f, [a(env) for a in cargs], this=this)
            return run
        cf = self.expr(callee)

        def run(env):
            return interp.call_function(cf(env), [a(env) for a in cargs])
        return run

    def e_new(self, n):
        _, callee, argnodes = n
        cf = self.expr(callee)
        cargs = [self.expr(a) for a in argnodes]
        interp = self.interp

        def run(env):
            return interp.construct(cf(env), [a(env) for a in cargs])
        return run

    def e_member(self, n):
        cobj = self.expr(n[1])
        key = n[2]
        interp = self.interp
        return lambda env: interp.get_prop(cobj(env), key)

    def e_index(self, n):
        cobj = self.expr(n[1])
        ckey = self.expr(n[2])
        interp = self.interp

        def run(env):
            o = cobj(env)
            k = ckey(env)
            if isinstance(k, int) and type(o) in (JSTypedArray, JSArray):
                # fast path: numeric index on arrays
                if type(o) is JSTypedArray:
                    d = o.data
                    return d[k] if 0 <= k < len(d) else UNDEF
                it = o.items
                return it[k] if 0 <= k < len(it) else UNDEF
            return interp.get_prop(o, interp.prop_key(k))
        return run

    def e_cond(self, n):
        c = self.expr(n[1])
        a = self.expr(n[2])
        b = self.expr(n[3])
        return lambda env: a(env) if js_truthy(c(env)) else b(env)

    def e_logic(self, n):
        op = n[1]
        l = self.expr(n[2])
        r = self.expr(n[3])
        if op == "&&":
            def run(env):
                v = l(env)
                return r(env) if js_truthy(v) else v
        else:
            def run(env):
                v = l(env)
                return v if js_truthy(v) else r(env)
        return run

    def e_binop(self, n):
        op = n[1]
        l = self.expr(n[2])
        r = self.expr(n[3])
        interp = self.interp
        if op == "+":
            def run(env):
                a = l(env)
                b = r(env)
                if type(a) in (int, float) and type(b) in (int, float):
                    return a + b
                if isinstance(a, str) or isinstance(b, str) or isinstance(a, (JSObject, JSArray)) or isinstance(b, (JSObject, JSArray)):
                    return js_str(a) + js_str(b)
                return js_tonumber(a) + js_tonumber(b)
            return run
        if op == "-":
            return lambda env: js_tonumber(l(env)) - js_tonumber(r(env))
        if op == "*":
            return lambda env: js_tonumber(l(env)) * js_tonumber(r(env))
        if op == "/":
            def run(env):
                a = js_tonumber(l(env))
                b = js_tonumber(r(env))
                if b == 0:
                    if a != a or a == 0:
                        return math.nan
                    sign = math.copysign(1, a) * math.copysign(1, b)
                    return math.inf * sign
                return a / b
            return run
        if op == "%":
            def run(env):
                a = js_tonumber(l(env))
                b = js_tonumber(r(env))
                if b == 0 or a != a or b != b:
                    return math.nan
                v = math.fmod(a, b)
                if isinstance(a, int) and isinstance(b, int):
                    return int(v)
                return v
            return run
        if op in ("<", ">", "<=", ">="):
            import operator as _op
            f = {"<": _op.lt, ">": _op.gt, "<=": _op.le, ">=": _op.ge}[op]

            def run(env):
                a = l(env)
                b = r(env)
                if isinstance(a, str) and isinstance(b, str):
                    return f(a, b)
                a = js_tonumber(a)
                b = js_tonumber(b)
                if a != a or b != b:
                    return False
                return f(a, b)
            return run
        if op == "==":
            return lambda env: js_eq_loose(l(env), r(env))
        if op == "!=":
            return lambda env: not js_eq_loose(l(env), r(env))
        if op == "===":
            return lambda env: js_eq_strict(l(env), r(env))
        if op == "!==":
            return lambda env: not js_eq_strict(l(env), r(env))
        if op == "&":
            return lambda env: to_int32(to_int32(l(env)) & to_int32(r(env)))
        if op == "|":
            return lambda env: to_int32(to_int32(l(env)) | to_int32(r(env)))
        if op == "^":
            return lambda env: to_int32(to_int32(l(env)) ^ to_int32(r(env)))
        if op == "<<":
            return lambda env: to_int32(to_int32(l(env)) << (to_uint32(r(env)) & 31))
        if op == ">>":
            return lambda env: to_int32(l(env)) >> (to_uint32(r(env)) & 31)
        if op == ">>>":
            return lambda env: to_uint32(l(env)) >> (to_uint32(r(env)) & 31)
        if op == "instanceof":
            def run(env):
                a = l(env)
                f = r(env)
                return interp.instance_of(a, f)
            return run
        if op == "in":
            def run(env):
                k = interp.prop_key(l(env))
                o = r(env)
                return not (interp.get_prop(o, k) is UNDEF)
            return run
        raise SyntaxError("jsvm: unknown binop " + op)

    def e_unary(self, n):
        op = n[1]
        interp = self.interp
        if op == "typeof" and n[2][0] == "name":
            # typeof on an unresolvable name is "undefined", not a throw
            name = n[2][1]

            def run(env):
                e = env
                while e is not None:
                    v = e.vars.get(name, _MISSING)
                    if v is not _MISSING:
                        return interp.type_of(v)
                    e = e.parent
                return "undefined"
            return run
        c = self.expr(n[2])
        if op == "!":
            return lambda env: not js_truthy(c(env))
        if op == "~":
            return lambda env: to_int32(~to_int32(c(env)))
        if op == "-":
            return lambda env: -js_tonumber(c(env))
        if op == "+":
            return lambda env: js_tonumber(c(env))
        if op == "typeof":
            return lambda env: interp.type_of(c(env))
        if op == "void":
            def run(env):
                c(env)
                return UNDEF
            return run
        if op == "delete":
            node = n[2]
            if node[0] == "member":
                cobj = self.expr(node[1])
                key = node[2]

                def run(env):
                    o = cobj(env)
                    if isinstance(o, JSObject):
                        o.props.pop(key, None)
                    return True
                return run
            if node[0] == "index":
                cobj = self.expr(node[1])
                ckey = self.expr(node[2])

                def run(env):
                    o = cobj(env)
                    k = interp.prop_key(ckey(env))
                    if isinstance(o, JSObject):
                        o.props.pop(k, None)
                    return True
                return run
            return lambda env: True
        raise SyntaxError("jsvm: unknown unary " + op)

    def e_update(self, n):
        _, op, prefix, target = n
        delta = 1 if op == "++" else -1
        interp = self.interp
        if target[0] == "name":
            name = target[1]

            def run(env):
                e = env
                while e is not None:
                    if name in e.vars:
                        old = js_tonumber(e.vars[name])
                        e.vars[name] = old + delta
                        return old + delta if prefix else old
                    e = e.parent
                raise JSError(interp.make_error("ReferenceError", name))
            return run
        if target[0] == "member":
            cobj = self.expr(target[1])
            key = target[2]

            def run(env):
                o = cobj(env)
                old = js_tonumber(interp.get_prop(o, key))
                interp.set_prop(o, key, old + delta)
                return old + delta if prefix else old
            return run
        cobj = self.expr(target[1])
        ckey = self.expr(target[2])

        def run(env):
            o = cobj(env)
            k = ckey(env)
            if isinstance(k, int) and type(o) is JSTypedArray:
                d = o.data
                old = d[k] if 0 <= k < len(d) else 0
                nv = old + delta
                if 0 <= k < len(d):
                    d[k] = max(0, min(255, nv)) if o.clamped else nv & 0xFF
                return nv if prefix else old
            k = interp.prop_key(k)
            old = js_tonumber(interp.get_prop(o, k))
            interp.set_prop(o, k, old + delta)
            return old + delta if prefix else old
        return run

    def e_assign(self, n):
        _, op, target, value = n
        cval = self.expr(value)
        interp = self.interp
        if op != "=":
            binop = ("binop", op[:-1], target, value)
            cval = self.expr(binop)
        if target[0] == "name":
            name = target[1]

            def run(env):
                v = cval(env)
                e = env
                while e is not None:
                    if name in e.vars:
                        e.vars[name] = v
                        return v
                    if e.parent is None:
                        e.vars[name] = v  # sloppy-mode implicit global
                        return v
                    e = e.parent
                return v
            return run
        if target[0] == "member":
            cobj = self.expr(target[1])
            key = target[2]

            def run(env):
                o = cobj(env)
                v = cval(env)
                interp.set_prop(o, key, v)
                return v
            return run
        cobj = self.expr(target[1])
        ckey = self.expr(target[2])

        def run(env):
            o = cobj(env)
            k = ckey(env)
            v = cval(env)
            if isinstance(k, int) and type(o) is JSTypedArray:
                d = o.data
                if 0 <= k < len(d):
                    iv = int(js_tonumber(v))
                    d[k] = max(0, min(255, iv)) if o.clamped else iv & 0xFF
                return v
            interp.set_prop(o, interp.prop_key(k), v)
            return v
        return run

    # --- statements ---
    def stmt(self, node):
        t = node[0]
        return getattr(self, "s_" + t)(node)

    def s_block(self, n):
        # create a fresh env only when the block introduces lexical names
        has_lex = any(
            s[0] == "var" and s[1] in ("let", "const") or s[0] == "fundecl"
            for s in n[1]
        )
        stmts = [self.stmt(s) for s in n[1]]
        fdecls = [
            (s[1], self.expr(s[2])) for s in n[1] if s[0] == "fundecl"
        ]

        if has_lex:
            def run(env):
                benv = Env(env)
                for name, cf in fdecls:
                    benv.vars[name] = cf(benv)
                for s in stmts:
                    s(benv)
        else:
            def run(env):
                for s in stmts:
                    s(env)
        return run

    def s_empty(self, n):
        return lambda env: None

    def s_expr(self, n):
        c = self.expr(n[1])

        def run(env):
            c(env)
        return run

    def s_var(self, n):
        decls = [(name, self.expr(init) if init is not None else None) for name, init in n[2]]
        kind = n[1]

        def run(env):
            for name, cinit in decls:
                if cinit is not None:
                    v = cinit(env)
                    env.vars[name] = v
                elif kind != "var" or name not in env.vars:
                    env.vars[name] = UNDEF
        return run

    def s_fundecl(self, n):
        # assigned during hoisting; re-assignment at statement position is a
        # no-op (function decls bind at scope entry)
        return lambda env: None

    def s_if(self, n):
        c = self.expr(n[1])
        a = self.stmt(n[2])
        b = self.stmt(n[3]) if n[3] is not None else None

        def run(env):
            if js_truthy(c(env)):
                a(env)
            elif b is not None:
                b(env)
        return run

    def s_while(self, n):
        c = self.expr(n[1])
        body = self.stmt(n[2])

        def run(env):
            while js_truthy(c(env)):
                try:
                    body(env)
                except _Continue:
                    continue
                except _Break:
                    break
        return run

    def s_dowhile(self, n):
        body = self.stmt(n[1])
        c = self.expr(n[2])

        def run(env):
            while True:
                try:
                    body(env)
                except _Continue:
                    pass
                except _Break:
                    break
                if not js_truthy(c(env)):
                    break
        return run

    def s_for(self, n):
        _, init, cond, upd, body = n
        cinit = self.stmt(init) if init is not None else None
        ccond = self.expr(cond) if cond is not None else None
        cupd = self.expr(upd) if upd is not None else None
        cbody = self.stmt(body)
        lexical = init is not None and init[0] == "var" and init[1] in ("let", "const")

        def run(env):
            fenv = Env(env) if lexical else env
            if cinit is not None:
                cinit(fenv)
            while ccond is None or js_truthy(ccond(fenv)):
                try:
                    cbody(fenv)
                except _Continue:
                    pass
                except _Break:
                    break
                if cupd is not None:
                    cupd(fenv)
        return run

    def s_return(self, n):
        if n[1] is None:
            def run(env):
                raise _Return(UNDEF)
        else:
            c = self.expr(n[1])

            def run(env):
                raise _Return(c(env))
        return run

    def s_break(self, n):
        def run(env):
            raise _BREAK
        return run

    def s_continue(self, n):
        def run(env):
            raise _CONT
        return run

    def s_switch(self, n):
        disc = self.expr(n[1])
        cases = []
        for test, body in n[2]:
            ctest = self.expr(test) if test is not None else None
            cbody = [self.stmt(s) for s in body]
            cases.append((ctest, cbody))

        def run(env):
            senv = Env(env)
            d = disc(senv)
            start = None
            for i, (ctest, _) in enumerate(cases):
                if ctest is not None and js_eq_strict(d, ctest(senv)):
                    start = i
                    break
            if start is None:
                for i, (ctest, _) in enumerate(cases):
                    if ctest is None:
                        start = i
                        break
            if start is None:
                return
            try:
                for _, cbody in cases[start:]:
                    for s in cbody:
                        s(senv)
            except _Break:
                pass
        return run

    def s_throw(self, n):
        c = self.expr(n[1])

        def run(env):
            raise JSError(c(env))
        return run

    def s_try(self, n):
        _, block, param, catch, fin = n
        cblock = self.stmt(block)
        ccatch = self.stmt(catch) if catch is not None else None
        cfin = self.stmt(fin) if fin is not None else None

        def run(env):
            try:
                try:
                    cblock(env)
                except JSError as ex:
                    if ccatch is None:
                        raise
                    cenv = Env(env)
                    if param is not None:
                        cenv.vars[param] = ex.value
                    ccatch(cenv)
            finally:
                if cfin is not None:
                    cfin(env)
        return run


# ---------------------------------------------------------------------------
# interpreter / runtime
# ---------------------------------------------------------------------------

class Interpreter:
    def __init__(self):
        self.global_env = Env()
        self.console = []  # (level, message) capture
        self.tasks = []  # event-loop queue of Python thunks
        self._install_globals(self.global_env)
        _CURRENT[0] = self

    # --- public API ---
    def eval_script(self, src, env=None):
        env = env or self.global_env
        ast = Parser(src).parse_program()
        comp = Compiler(self, src)
        vars_out, funcs_out = [], []
        for s in ast[1]:
            _hoist(s, vars_out, funcs_out)
        for name in vars_out:
            if name not in env.vars:
                env.vars[name] = UNDEF
        for fname, fnode in funcs_out:
            env.vars[fname] = comp.expr(fnode)(env)
        # execute top-level statements directly in `env` (not as a block):
        # top-level let/const must land in the script's global scope
        for s in ast[1]:
            comp.stmt(s)(env)

    def new_realm_env(self):
        """A fresh global scope (worker context) sharing builtins."""
        env = Env()
        self._install_globals(env)
        return env

    def call_function(self, f, args, this=UNDEF, name=None):
        if isinstance(f, NativeFunction):
            return f.fn(this, args)
        if not isinstance(f, JSFunction):
            raise JSError(self.make_error(
                "TypeError", f"{name or js_str(f)} is not a function"))
        env = Env(f.env)
        v = env.vars
        v["this"] = this
        if f.name:
            v.setdefault(f.name, f)
        params = f.params
        na = len(args)
        for i, p in enumerate(params):
            v[p] = args[i] if i < na else UNDEF
        v["arguments"] = JSArray(list(args))
        for vn in f.vars:
            if vn not in v:
                v[vn] = UNDEF
        for fname, cf in f.funcs:
            v[fname] = cf(env)
        try:
            f.body(env)
        except _Return as r:
            return r.value
        return UNDEF

    def construct(self, f, args):
        if isinstance(f, NativeFunction):
            if f.ctor is None:
                raise JSError(self.make_error("TypeError", f.name + " is not a constructor"))
            return f.ctor(args)
        if not isinstance(f, JSFunction):
            raise JSError(self.make_error("TypeError", "not a constructor"))
        obj = JSObject(proto=f.prototype())
        r = self.call_function(f, args, this=obj)
        return r if isinstance(r, (JSObject, JSArray, JSTypedArray, JSArrayBuffer)) else obj

    def instance_of(self, a, f):
        if isinstance(f, NativeFunction):
            want = f.name
            if want == "Uint8Array":
                return isinstance(a, JSTypedArray) and not a.clamped
            if want == "Uint8ClampedArray":
                return isinstance(a, JSTypedArray) and a.clamped
            if want == "ArrayBuffer":
                return isinstance(a, JSArrayBuffer)
            if want == "Array":
                return isinstance(a, JSArray)
            if isinstance(a, JSObject):
                proto = f.props.get("prototype")
                o = a.proto
                while o is not None:
                    if o is proto:
                        return True
                    o = o.proto
            return False
        if isinstance(f, JSFunction):
            proto = f.prototype()
            if isinstance(a, JSObject):
                o = a.proto
                while o is not None:
                    if o is proto:
                        return True
                    o = o.proto
            return False
        raise JSError(self.make_error("TypeError", "Right-hand side of instanceof is not callable"))

    def type_of(self, v):
        if v is UNDEF:
            return "undefined"
        if v is None:
            return "object"
        if isinstance(v, bool):
            return "boolean"
        if isinstance(v, (int, float)):
            return "number"
        if isinstance(v, str):
            return "string"
        if isinstance(v, (JSFunction, NativeFunction)):
            return "function"
        return "object"

    def prop_key(self, k):
        if isinstance(k, int):
            return k
        if isinstance(k, float) and k.is_integer():
            return int(k)
        if isinstance(k, str):
            return k
        return js_str(k)

    def make_error(self, kind, msg):
        o = JSObject(cls="Error")
        o.props["name"] = kind
        o.props["message"] = msg
        o.props["stack"] = kind + ": " + msg
        o.props["toString"] = NativeFunction(
            "toString", lambda this, args: js_str(this.get("name")) + ": " + js_str(this.get("message"))
        )
        return o

    # --- property access ---
    def get_prop(self, o, key):
        to = type(o)
        if to is JSTypedArray:
            if isinstance(key, int):
                return o.data[key] if 0 <= key < len(o.data) else UNDEF
            if key == "length" or key == "byteLength":
                return len(o.data)
            if key == "buffer":
                return JSArrayBuffer(o.data)
            return self._typed_method(o, key)
        if to is JSArray:
            if isinstance(key, int):
                return o.items[key] if 0 <= key < len(o.items) else UNDEF
            if key == "length":
                return len(o.items)
            return self._array_method(o, key)
        if isinstance(o, JSObject):
            return o.get(key)
        if isinstance(o, str):
            if isinstance(key, int):
                return o[key] if 0 <= key < len(o) else UNDEF
            if key == "length":
                return len(o)
            return self._string_method(o, key)
        if to is JSArrayBuffer:
            if key == "byteLength":
                return len(o.data)
            if key == "slice":
                def _slice(this, args):
                    a = int(js_tonumber(args[0])) if args else 0
                    b = args[1] if len(args) > 1 else UNDEF
                    b = len(o.data) if b is UNDEF else int(js_tonumber(b))
                    return JSArrayBuffer(bytearray(o.data[a:b]))
                return NativeFunction("slice", _slice)
            return UNDEF
        if o is UNDEF or o is None:
            raise JSError(self.make_error(
                "TypeError", f"Cannot read properties of {js_str(o)} (reading '{key}')"))
        if isinstance(o, (int, float)):
            if key == "toString":
                return NativeFunction("toString", lambda this, args: js_str(o))
            return UNDEF
        return UNDEF

    def set_prop(self, o, key, v):
        to = type(o)
        if to is JSTypedArray:
            if isinstance(key, int):
                if 0 <= key < len(o.data):
                    iv = int(js_tonumber(v))
                    o.data[key] = max(0, min(255, iv)) if o.clamped else iv & 0xFF
                return
            return  # length etc. read-only
        if to is JSArray:
            if isinstance(key, int):
                items = o.items
                if key >= len(items):
                    items.extend([UNDEF] * (key + 1 - len(items)))
                items[key] = v
                return
            if key == "length":
                nl = int(js_tonumber(v))
                cur = len(o.items)
                if nl < cur:
                    del o.items[nl:]
                else:
                    o.items.extend([UNDEF] * (nl - cur))
                return
            return
        if isinstance(o, JSObject):
            o.props[key] = v
            return
        if o is UNDEF or o is None:
            raise JSError(self.make_error(
                "TypeError", f"Cannot set properties of {js_str(o)} (setting '{key}')"))
        # primitives: silently ignore

    # --- builtin methods ---
    def _array_method(self, arr, key):
        items = arr.items
        if key == "push":
            def fn(this, args):
                items.extend(args)
                return len(items)
        elif key == "pop":
            def fn(this, args):
                return items.pop() if items else UNDEF
        elif key == "shift":
            def fn(this, args):
                return items.pop(0) if items else UNDEF
        elif key == "unshift":
            def fn(this, args):
                for a in reversed(args):
                    items.insert(0, a)
                return len(items)
        elif key == "slice":
            def fn(this, args):
                a = int(js_tonumber(args[0])) if args and args[0] is not UNDEF else 0
                b = len(items) if len(args) < 2 or args[1] is UNDEF else int(js_tonumber(args[1]))
                return JSArray(items[a:b])
        elif key == "indexOf":
            def fn(this, args):
                want = args[0] if args else UNDEF
                for i, it in enumerate(items):
                    if js_eq_strict(it, want):
                        return i
                return -1
        elif key == "join":
            def fn(this, args):
                sep = js_str(args[0]) if args and args[0] is not UNDEF else ","
                return sep.join("" if x is UNDEF or x is None else js_str(x) for x in items)
        elif key == "forEach":
            def fn(this, args):
                cb = args[0]
                for i, it in enumerate(list(items)):
                    self.call_function(cb, [it, i, arr])
                return UNDEF
        elif key == "concat":
            def fn(this, args):
                out = list(items)
                for a in args:
                    if isinstance(a, JSArray):
                        out.extend(a.items)
                    else:
                        out.append(a)
                return JSArray(out)
        elif key == "toString":
            def fn(this, args):
                return js_str(arr)
        else:
            return UNDEF
        return NativeFunction(key, fn)

    def _typed_method(self, ta, key):
        if key == "set":
            def fn(this, args):
                src = args[0]
                off = int(js_tonumber(args[1])) if len(args) > 1 else 0
                if isinstance(src, JSTypedArray):
                    ta.data[off : off + len(src.data)] = src.data
                elif isinstance(src, JSArray):
                    for i, v in enumerate(src.items):
                        ta.data[off + i] = int(js_tonumber(v)) & 0xFF
                return UNDEF
        elif key == "slice":
            def fn(this, args):
                a = int(js_tonumber(args[0])) if args and args[0] is not UNDEF else 0
                b = len(ta.data) if len(args) < 2 or args[1] is UNDEF else int(js_tonumber(args[1]))
                return JSTypedArray(bytearray(ta.data[a:b]), ta.clamped)
        elif key == "subarray":
            def fn(this, args):
                a = int(js_tonumber(args[0])) if args and args[0] is not UNDEF else 0
                b = len(ta.data) if len(args) < 2 or args[1] is UNDEF else int(js_tonumber(args[1]))
                return JSTypedArray(bytearray(ta.data[a:b]), ta.clamped)
        elif key == "fill":
            def fn(this, args):
                v = int(js_tonumber(args[0])) & 0xFF if args else 0
                for i in range(len(ta.data)):
                    ta.data[i] = v
                return ta
        else:
            return UNDEF
        return NativeFunction(key, fn)

    def _string_method(self, s, key):
        if key == "charCodeAt":
            def fn(this, args):
                i = int(js_tonumber(args[0])) if args else 0
                return ord(s[i]) if 0 <= i < len(s) else math.nan
        elif key == "charAt":
            def fn(this, args):
                i = int(js_tonumber(args[0])) if args else 0
                return s[i] if 0 <= i < len(s) else ""
        elif key == "substring":
            def fn(this, args):
                a = int(js_tonumber(args[0])) if args else 0
                b = len(s) if len(args) < 2 or args[1] is UNDEF else int(js_tonumber(args[1]))
                a = max(0, min(len(s), a))
                b = max(0, min(len(s), b))
                if a > b:
                    a, b = b, a
                return s[a:b]
            return NativeFunction(key, fn)
        elif key == "indexOf":
            def fn(this, args):
                return s.find(js_str(args[0])) if args else -1
        elif key == "lastIndexOf":
            def fn(this, args):
                return s.rfind(js_str(args[0])) if args else -1
        elif key == "toString":
            def fn(this, args):
                return s
        elif key == "split":
            def fn(this, args):
                sep = js_str(args[0]) if args else UNDEF
                return JSArray(list(s.split(sep)))
        else:
            return UNDEF
        return NativeFunction(key, fn)

    # --- globals ---
    def _install_globals(self, env):
        g = env.vars

        def native(name, fn, ctor=None):
            g[name] = NativeFunction(name, fn, ctor)

        # Math
        mathobj = JSObject()
        def _mm(name, f):
            mathobj.props[name] = NativeFunction(name, lambda this, args, f=f: f(*[js_tonumber(a) for a in args]))
        _mm("trunc", lambda x=0: math.trunc(x) if x == x and abs(x) != math.inf else x)
        _mm("floor", lambda x=0: math.floor(x))
        _mm("ceil", lambda x=0: math.ceil(x))
        _mm("round", lambda x=0: math.floor(x + 0.5) if x == x else x)
        _mm("abs", lambda x=0: abs(x))
        _mm("max", lambda *a: max(a) if a else -math.inf)
        _mm("min", lambda *a: min(a) if a else math.inf)
        _mm("sqrt", lambda x=0: math.sqrt(x) if x >= 0 else math.nan)
        _mm("pow", lambda x=0, y=0: x ** y)
        mathobj.props["PI"] = math.pi
        g["Math"] = mathobj

        # console
        def _console(level):
            def fn(this, args):
                self.console.append((level, " ".join(js_str(a) for a in args)))
                return UNDEF
            return fn
        cons = JSObject()
        for lvl in ("log", "error", "warn", "info", "debug"):
            cons.props[lvl] = NativeFunction(lvl, _console(lvl))
        g["console"] = cons

        # String (with fromCharCode static)
        def _string_call(this, args):
            return js_str(args[0]) if args else ""
        sfn = NativeFunction("String", _string_call, ctor=lambda args: js_str(args[0]) if args else "")
        sfn.props["fromCharCode"] = NativeFunction(
            "fromCharCode", lambda this, args: "".join(chr(int(js_tonumber(a)) & 0xFFFF) for a in args)
        )
        g["String"] = sfn

        # Number / parseInt / isNaN
        g["NaN"] = math.nan
        g["Infinity"] = math.inf
        native("isNaN", lambda this, args: js_tonumber(args[0]) != js_tonumber(args[0]) if args else True)
        native("parseInt", lambda this, args: self._parse_int(args))
        numfn = NativeFunction("Number", lambda this, args: js_tonumber(args[0]) if args else 0,
                               ctor=lambda args: js_tonumber(args[0]) if args else 0)
        g["Number"] = numfn

        # Array
        def _array_ctor(args):
            if len(args) == 1 and isinstance(args[0], (int, float)):
                return JSArray([UNDEF] * int(args[0]))
            return JSArray(list(args))
        arrfn = NativeFunction("Array", lambda this, args: _array_ctor(args), ctor=_array_ctor)
        arrfn.props["isArray"] = NativeFunction("isArray", lambda this, args: isinstance(args[0], JSArray) if args else False)
        g["Array"] = arrfn

        # Typed arrays / ArrayBuffer
        def _u8_ctor(clamped):
            def ctor(args):
                a = args[0] if args else 0
                if isinstance(a, (int, float)):
                    return JSTypedArray(bytearray(int(a)), clamped)
                if isinstance(a, JSArrayBuffer):
                    return JSTypedArray(a.data, clamped)  # view: shared bytes
                if isinstance(a, JSTypedArray):
                    return JSTypedArray(bytearray(a.data), clamped)
                if isinstance(a, JSArray):
                    return JSTypedArray(
                        bytearray(int(js_tonumber(x)) & 0xFF for x in a.items), clamped
                    )
                return JSTypedArray(bytearray(0), clamped)
            return ctor
        native("Uint8Array", lambda this, args: UNDEF, _u8_ctor(False))
        native("Uint8ClampedArray", lambda this, args: UNDEF, _u8_ctor(True))
        native("ArrayBuffer", lambda this, args: UNDEF,
               lambda args: JSArrayBuffer(bytearray(int(js_tonumber(args[0])) if args else 0)))

        # Error family
        def _err_ctor(kind):
            def ctor(args):
                return self.make_error(kind, js_str(args[0]) if args and args[0] is not UNDEF else "")
            return ctor
        for kind in ("Error", "TypeError", "RangeError", "ReferenceError", "SyntaxError"):
            g[kind] = NativeFunction(kind, lambda this, args, k=kind: self.make_error(k, js_str(args[0]) if args else ""), _err_ctor(kind))

        # Object (bare minimum)
        objfn = NativeFunction("Object", lambda this, args: JSObject(), ctor=lambda args: JSObject())
        g["Object"] = objfn

        # Promise: synchronous-resolution shim (the harness event loop makes
        # every resolution happen from a queued task, after .then attaches)
        def _promise_ctor(args):
            p = JSObject(cls="Promise")
            p.props["_state"] = "pending"
            p.props["_value"] = UNDEF
            p.props["_cbs"] = JSArray()
            p.props["_ecbs"] = JSArray()

            def settle(state, value):
                if p.props["_state"] != "pending":
                    return
                p.props["_state"] = state
                p.props["_value"] = value
                lst = p.props["_cbs" if state == "resolved" else "_ecbs"]
                for cb in lst.items:
                    self.call_function(cb, [value])

            resolve = NativeFunction("resolve", lambda this, a: settle("resolved", a[0] if a else UNDEF))
            reject = NativeFunction("reject", lambda this, a: settle("rejected", a[0] if a else UNDEF))

            def then(this, a):
                cb = a[0] if a else UNDEF
                if isinstance(cb, (JSFunction, NativeFunction)):
                    if p.props["_state"] == "resolved":
                        self.call_function(cb, [p.props["_value"]])
                    elif p.props["_state"] == "pending":
                        p.props["_cbs"].items.append(cb)
                return p

            def catch(this, a):
                cb = a[0] if a else UNDEF
                if isinstance(cb, (JSFunction, NativeFunction)):
                    if p.props["_state"] == "rejected":
                        self.call_function(cb, [p.props["_value"]])
                    elif p.props["_state"] == "pending":
                        p.props["_ecbs"].items.append(cb)
                return p

            p.props["then"] = NativeFunction("then", then)
            p.props["catch"] = NativeFunction("catch", catch)
            if args:
                self.call_function(args[0], [resolve, reject])
            return p
        native("Promise", lambda this, args: UNDEF, _promise_ctor)

        # function methods via a shared prototype-ish dispatch: call/apply
        # are resolved in get_prop for JSFunction/NativeFunction objects
        # (installed here as fallback props on demand)

    def _parse_int(self, args):
        if not args:
            return math.nan
        s = js_str(args[0]).strip()
        base = int(js_tonumber(args[1])) if len(args) > 1 and args[1] is not UNDEF else 10
        m = re.match(r"[+-]?[0-9a-zA-Z]+", s)
        if not m:
            return math.nan
        try:
            return int(m.group(0), base)
        except ValueError:
            return math.nan


# function .call/.apply/.toString support hooks into get_prop


def _function_prop(interp, f, key):
    if key == "call":
        def fn(this, args):
            t = args[0] if args else UNDEF
            return interp.call_function(f, list(args[1:]), this=t)
        return NativeFunction("call", fn)
    if key == "apply":
        def fn(this, args):
            t = args[0] if args else UNDEF
            rest = args[1].items if len(args) > 1 and isinstance(args[1], JSArray) else []
            return interp.call_function(f, list(rest), this=t)
        return NativeFunction("apply", fn)
    if key == "toString":
        return NativeFunction("toString", lambda this, args: js_str(f))
    if key == "bind":
        def fn(this, args):
            t = args[0] if args else UNDEF
            pre = list(args[1:])

            def bound(this2, args2):
                return interp.call_function(f, pre + list(args2), this=t)
            return NativeFunction("bound " + (getattr(f, "name", "") or ""), bound)
        return NativeFunction("bind", fn)
    return None


_orig_get_prop = Interpreter.get_prop


def _get_prop_with_funcs(self, o, key):
    if isinstance(o, (JSFunction, NativeFunction)):
        v = o.props.get(key, _MISSING)
        if v is not _MISSING:
            return v
        if key == "prototype" and isinstance(o, JSFunction):
            return o.prototype()
        fp = _function_prop(self, o, key)
        if fp is not None:
            return fp
        if key == "name":
            return o.name or ""
        return UNDEF
    return _orig_get_prop(self, o, key)


Interpreter.get_prop = _get_prop_with_funcs

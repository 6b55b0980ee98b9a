"""Guided (constrained) decoding: finite-state token masks. The port's own
copy of ray_tpu/llm/guided.py (numpy only; the port imports nothing of the
JAX package).

A guided request carries a finite-state machine over token ids:
``masks[S, V]`` (allowed tokens per state) and ``trans[S, V]`` (next state
per token). Each decode step the engine adds a per-slot bias (0 where
allowed, -1e9 elsewhere, ``bias_row``) to the f32 logits before sampling;
the FSM state advance is a host-side table lookup on the emitted token.
The bias rows are the only extra host-to-device traffic (slots x vocab f32
a step).

Builders:

- :meth:`GuidedFSM.from_choices` — output must be exactly one of N token
  sequences: a token trie whose terminal state admits only EOS.
- :meth:`GuidedFSM.from_token_sets` — positional template: step i must
  draw from ``sets[i]``, then EOS.
- :meth:`GuidedFSM.from_regex` — a regex over single-character tokens
  (token id == code point), compiled to a DFA.
"""

from __future__ import annotations

import dataclasses

import numpy as np

NEG = np.float32(-1e9)


@dataclasses.dataclass
class GuidedFSM:
    """masks[S, V] bool (True = allowed), trans[S, V] int32, start state.

    ``eos_id`` (when ≥ 0) enables BUDGET-AWARE closing: per-state
    distance-to-accept is precomputed, and once a request's remaining
    max_tokens only just covers that distance the engine switches to a
    closing mask that admits only budget-decreasing tokens — an unbounded
    ``[a-z]+`` can then never overrun max_tokens mid-pattern."""

    masks: np.ndarray
    trans: np.ndarray
    start: int = 0
    eos_id: int = -1

    def __post_init__(self):
        if self.masks.shape != self.trans.shape:
            raise ValueError(
                f"masks {self.masks.shape} / trans {self.trans.shape} "
                "shape mismatch")
        if not (0 <= self.start < self.masks.shape[0]):
            raise ValueError(f"start state {self.start} out of range")
        # precomputed additive biases [S, V]: the decode hot loop indexes a
        # row per step instead of running a full-vocab np.where per slot
        self._biases = np.where(self.masks, np.float32(0.0), NEG)
        # distance-to-accept is computed LAZILY: a guided_choice request
        # builds a fresh FSM per request and (with max_tokens bumped past
        # the longest choice) never consults it — paying O(S*V) setup
        # there buys nothing
        self._dist: np.ndarray | None = None

    @property
    def dist(self) -> np.ndarray:
        """Per-state minimum tokens (excl. eos) to reach an accepting
        state; int32-max where acceptance is unreachable."""
        self._ensure_closing()
        return self._dist

    def _ensure_closing(self) -> None:
        if self._dist is not None:
            return
        S, V = self.masks.shape
        dist = np.full((S,), np.iinfo(np.int32).max, np.int64)
        if 0 <= self.eos_id < V:
            # reverse BFS from accepting states (eos admitted there)
            dist[self.masks[:, self.eos_id]] = 0
            frontier = list(np.nonzero(dist == 0)[0])
            radj: dict = {}
            for s in range(S):
                for t in np.nonzero(self.masks[s])[0]:
                    if t != self.eos_id:
                        radj.setdefault(int(self.trans[s, t]), []).append(s)
            d = 0
            while frontier:
                d += 1
                nxt = []
                for tgt in frontier:
                    for s in radj.get(int(tgt), ()):
                        if dist[s] > d:
                            dist[s] = d
                            nxt.append(s)
                frontier = nxt
        self._dist = dist

    @property
    def vocab_size(self) -> int:
        return self.masks.shape[1]

    def allowed(self, state: int) -> np.ndarray:
        return self.masks[state]

    def step(self, state: int, token: int) -> int:
        return int(self.trans[state, token])

    # ------------------------------------------------------------ builders

    @classmethod
    def from_choices(cls, choices: list, vocab_size: int,
                     eos_id: int) -> "GuidedFSM":
        """Token trie over ``choices`` (lists of token ids); at a complete
        choice only EOS is admitted (absorbing)."""
        if not choices:
            raise ValueError("from_choices needs at least one choice")
        # state 0 = root; assign states via trie insertion; final = EOS-only
        children: list[dict] = [{}]
        terminal: list[bool] = [False]
        for ch in choices:
            if not ch:
                raise ValueError("empty choice")
            s = 0
            for tok in ch:
                if not (0 <= tok < vocab_size):
                    raise ValueError(f"choice token {tok} outside vocab")
                nxt = children[s].get(tok)
                if nxt is None:
                    nxt = len(children)
                    children[s][tok] = nxt
                    children.append({})
                    terminal.append(False)
                s = nxt
            terminal[s] = True
        n = len(children) + 1  # + absorbing EOS-only state
        eos_state = n - 1
        masks = np.zeros((n, vocab_size), bool)
        trans = np.full((n, vocab_size), eos_state, np.int32)
        for s, kids in enumerate(children):
            for tok, nxt in kids.items():
                masks[s, tok] = True
                trans[s, tok] = nxt
            if terminal[s]:
                masks[s, eos_id] = True
                trans[s, eos_id] = eos_state
        masks[eos_state, eos_id] = True
        return cls(masks=masks, trans=trans, start=0, eos_id=eos_id)

    @classmethod
    def from_regex(cls, pattern: str, vocab_size: int, eos_id: int,
                   *, token_of: "callable | None" = None) -> "GuidedFSM":
        """Compile a regex SUBSET (literals, ``[...]`` classes incl.
        ranges/negation, ``.``, ``* + ?``, ``|``, ``( )``) to a DFA over
        token ids. ``token_of(char) -> token id`` maps symbols (default:
        ``ord`` — exact for byte-level tokenizers, where one token is one
        character; the ``guided_regex`` feature of the reference's
        structured-output stack). EOS is admitted exactly in accepting
        states."""
        nfa_start, nfa_accept = _regex_to_nfa(pattern)
        dfa = _nfa_to_dfa(nfa_start, nfa_accept)
        token_of = token_of or ord
        n = len(dfa.states) + 1
        eos_state = n - 1
        masks = np.zeros((n, vocab_size), bool)
        trans = np.full((n, vocab_size), eos_state, np.int32)
        for si, (edges, accepting) in enumerate(dfa.states):
            for ch, ti in edges.items():
                tok = token_of(ch)
                if not (0 <= tok < vocab_size):
                    raise ValueError(
                        f"regex symbol {ch!r} maps to token {tok} outside "
                        f"vocab {vocab_size}")
                masks[si, tok] = True
                trans[si, tok] = ti
            if accepting:
                masks[si, eos_id] = True
        masks[eos_state, eos_id] = True
        return cls(masks=masks, trans=trans, start=dfa.start,
                   eos_id=eos_id)

    @classmethod
    def from_token_sets(cls, sets: list, vocab_size: int,
                        eos_id: int) -> "GuidedFSM":
        """Positional template: position i draws from ``sets[i]``; after
        the last position only EOS is admitted."""
        n = len(sets) + 1
        eos_state = n - 1
        masks = np.zeros((n, vocab_size), bool)
        trans = np.full((n, vocab_size), eos_state, np.int32)
        for i, allowed in enumerate(sets):
            if not allowed:
                raise ValueError(f"position {i}: empty token set")
            for tok in allowed:
                if not (0 <= tok < vocab_size):
                    raise ValueError(f"token {tok} outside vocab")
                masks[i, tok] = True
                trans[i, tok] = i + 1
        masks[eos_state, eos_id] = True
        return cls(masks=masks, trans=trans, start=0, eos_id=eos_id)


def bias_row(fsm: GuidedFSM, state: int,
             remaining: int | None = None) -> np.ndarray:
    """Additive logit bias for one slot: 0 where allowed, -1e9 elsewhere
    (precomputed at FSM construction; this is a row view).

    With ``remaining`` (tokens of budget left incl. the one being sampled)
    the row is PER-TOKEN budget-feasible: token t stays allowed only if
    after taking it the leftover budget still covers the successor state's
    distance-to-accept plus the final EOS. This is inductive — a branch
    whose completion can't fit is masked BEFORE entering it (a state-level
    switch would fire too late for distance-INCREASING alternatives like
    'a|bcdef' at budget 3) — so outputs always complete within
    max_tokens."""
    if remaining is not None and fsm.eos_id >= 0:
        # S-1 bounds every finite distance: a budget beyond that can never
        # be tight, so the (lazy, cached) distance table isn't even built
        if remaining <= fsm.masks.shape[0]:
            fsm._ensure_closing()
            dist_next = fsm._dist[fsm.trans[state]]  # [V]
            feasible = fsm.masks[state] & (dist_next + 2 <= remaining)
            if fsm.masks[state, fsm.eos_id] and remaining >= 1:
                feasible = feasible.copy()
                feasible[fsm.eos_id] = True
            if feasible.any():
                return np.where(feasible, np.float32(0.0), NEG)
            # no feasible completion (caller under-budgeted below the
            # minimum): fall back to the plain mask — prefix-valid output
    return fsm._biases[state]


# ----------------------------------------------------- regex → NFA → DFA
# Thompson construction over an explicit character alphabet (printable
# ASCII by default): enough regex for the structured-output use cases
# (enums, numbers, identifiers, fixed-layout records) without importing a
# full engine. ``.`` and negated classes range over _ALPHABET.

_ALPHABET = [chr(c) for c in range(32, 127)]


class _NState:
    __slots__ = ("edges", "eps")

    def __init__(self):
        self.edges: dict = {}   # char -> _NState
        self.eps: list = []     # epsilon transitions


_SHORTHAND = {
    "d": set("0123456789"),
    "w": set("abcdefghijklmnopqrstuvwxyz"
             "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"),
    "s": set(" \t\n\r"),
}


def _read_symbol(pattern: str, i: int) -> tuple:
    """One class symbol at i; returns (char | shorthand-set, next_index).
    Unknown alphanumeric escapes raise — silently treating ``\\d`` as the
    letter 'd' would change the constraint without an error."""
    c = pattern[i]
    if c != "\\":
        return c, i + 1
    if i + 1 >= len(pattern):
        raise ValueError(f"dangling backslash in {pattern!r}")
    e = pattern[i + 1]
    if e in _SHORTHAND:
        return _SHORTHAND[e], i + 2
    if e.isalnum():
        raise ValueError(f"unsupported escape \\{e} in {pattern!r} "
                         "(supported: \\d \\w \\s and punctuation)")
    return e, i + 2


def _parse_class(pattern: str, i: int) -> tuple:
    """Parse ``[...]`` starting after '['; returns (chars, next_index)."""
    neg = i < len(pattern) and pattern[i] == "^"
    if neg:
        i += 1
    chars: set = set()
    while i < len(pattern) and pattern[i] != "]":
        sym, i = _read_symbol(pattern, i)
        if isinstance(sym, set):
            chars.update(sym)
            continue
        if (i + 1 < len(pattern) and pattern[i] == "-"
                and pattern[i + 1] != "]"):
            hi, i = _read_symbol(pattern, i + 1)
            if isinstance(hi, set):
                raise ValueError(
                    f"shorthand cannot end a range in {pattern!r}")
            if ord(hi) < ord(sym):
                raise ValueError(f"empty range {sym}-{hi} in {pattern!r}")
            chars.update(chr(x) for x in range(ord(sym), ord(hi) + 1))
        else:
            chars.add(sym)
    if i >= len(pattern):
        raise ValueError(f"unterminated character class in {pattern!r}")
    if neg:
        chars = set(_ALPHABET) - chars
    if not chars:
        raise ValueError(f"empty (or fully-negated) character class in "
                         f"{pattern!r}: it can never match")
    return sorted(chars), i + 1  # skip ']'


def _regex_to_nfa(pattern: str) -> tuple:
    """Recursive-descent Thompson construction. Returns (start, accept)."""

    def atom(i: int) -> tuple:
        """One atom; returns (start, end, next_i)."""
        if i >= len(pattern):
            raise ValueError(
                f"pattern ends where an atom was expected: {pattern!r}")
        c = pattern[i]
        if c == "(":
            s, e, i = alt(i + 1)
            if i >= len(pattern) or pattern[i] != ")":
                raise ValueError(f"unbalanced '(' in {pattern!r}")
            return s, e, i + 1
        if c == "[":
            chars, i = _parse_class(pattern, i + 1)
            s, e = _NState(), _NState()
            for ch in chars:
                s.edges.setdefault(ch, []).append(e)
            return s, e, i
        if c == ".":
            s, e = _NState(), _NState()
            for ch in _ALPHABET:
                s.edges.setdefault(ch, []).append(e)
            return s, e, i + 1
        if c == "\\":
            sym, i2 = _read_symbol(pattern, i)
            s, e = _NState(), _NState()
            for ch in (sym if isinstance(sym, set) else (sym,)):
                s.edges.setdefault(ch, []).append(e)
            return s, e, i2
        if c in ")|*+?":
            raise ValueError(f"unexpected {c!r} at {i} in {pattern!r}")
        s, e = _NState(), _NState()
        s.edges.setdefault(c, []).append(e)
        return s, e, i + 1

    def repeat(i: int) -> tuple:
        s, e, i = atom(i)
        while i < len(pattern) and pattern[i] in "*+?":
            op = pattern[i]
            ns, ne = _NState(), _NState()
            ns.eps.append(s)
            e.eps.append(ne)
            if op in "*?":
                ns.eps.append(ne)   # skip
            if op in "*+":
                e.eps.append(s)     # loop
            s, e, i = ns, ne, i + 1
        return s, e, i

    def concat(i: int) -> tuple:
        s, e, i = repeat(i)
        while i < len(pattern) and pattern[i] not in ")|":
            s2, e2, i = repeat(i)
            e.eps.append(s2)
            e = e2
        return s, e, i

    def alt(i: int) -> tuple:
        s, e, i = concat(i)
        while i < len(pattern) and pattern[i] == "|":
            s2, e2, i = concat(i + 1)
            ns, ne = _NState(), _NState()
            ns.eps.extend([s, s2])
            e.eps.append(ne)
            e2.eps.append(ne)
            s, e = ns, ne
        return s, e, i

    if not pattern:
        raise ValueError("empty regex")
    s, e, i = alt(0)
    if i != len(pattern):
        raise ValueError(f"trailing {pattern[i:]!r} in {pattern!r}")
    return s, e


class _Dfa:
    __slots__ = ("states", "start")

    def __init__(self, states, start):
        # states: list of (edges: {char: state_idx}, accepting: bool)
        self.states = states
        self.start = start


_MAX_DFA_STATES = 4096


def _nfa_to_dfa(start: "_NState", accept: "_NState") -> _Dfa:
    def closure(states: frozenset) -> frozenset:
        out = set(states)
        stack = list(states)
        while stack:
            st = stack.pop()
            for nxt in st.eps:
                if nxt not in out:
                    out.add(nxt)
                    stack.append(nxt)
        return frozenset(out)

    start_set = closure(frozenset([start]))
    index = {start_set: 0}
    worklist = [start_set]
    states: list = [({}, accept in start_set)]
    while worklist:
        cur = worklist.pop()
        ci = index[cur]
        by_char: dict = {}
        for st in cur:
            for ch, targets in st.edges.items():
                by_char.setdefault(ch, set()).update(targets)
        for ch, targets in by_char.items():
            nxt = closure(frozenset(targets))
            if nxt not in index:
                if len(states) >= _MAX_DFA_STATES:
                    # subset construction can blow up exponentially
                    # ((Σ)*aΣ^n forms); user-supplied patterns on the
                    # serving path must not be a memory/CPU DoS vector
                    raise ValueError(
                        f"regex compiles to more than {_MAX_DFA_STATES} "
                        "DFA states; simplify the pattern")
                index[nxt] = len(states)
                states.append(({}, accept in nxt))
                worklist.append(nxt)
            states[ci][0][ch] = index[nxt]
    return _Dfa(states, 0)

"""The traffic generator: the programs a cell's client sends, drawn from
the seed.

A configuration's file gives its program class as data: a loop body of
instructions whose immediates are fixed, registers, or drawn per program
("word": any word; "shift": 1 .. W-1; "divisor": 1 .. 2^(W/2) - 1;
{"address": s}: memory address slot s, one distinct address per slot in
0 .. 2^(W-1) - 1).  Every program is the loop of BASELINE's
`config2_program` / `config3_program` (the port's
`tinyram/bench_programs.py`, copied here so that a change to the program
does not change the yardstick):

    Mov r0, iters; body; Sub r0 r0 1; Cmpe r0 0; CnJmp <body>; Answer r<a>

with iters = max(1, (2^steps_log2 - 2) // (len(body) + 3)), so every
program of a class and a size runs the same number of steps and memory
accesses, whatever the draws.  The size is the configuration's
`steps_log2`, unless the traffic mix gives a list of them: each seed then
sends the same list, in an order drawn from the seed.

A program is a list of (op, ri, rj, ("imm", v) | ("reg", r)) tuples, which
the harness turns into the port's instructions and the reference into its
own.
"""

from __future__ import annotations

import hashlib
import random


def stream(seed: int, label: str) -> random.Random:
    """An independent random stream for (seed, label)."""
    digest = hashlib.blake2b(f"{seed}:{label}".encode(), digest_size=16)
    return random.Random(int.from_bytes(digest.digest(), "little"))


def _operand(spec: dict, word_bits: int, rng: random.Random,
             addresses: dict) -> tuple:
    if "reg" in spec:
        return ("reg", int(spec["reg"]))
    if "imm" in spec:
        return ("imm", int(spec["imm"]))
    if "address" in spec:
        slot = int(spec["address"])
        if slot not in addresses:
            taken = set(addresses.values())
            while True:
                a = rng.randrange(1 << (word_bits - 1))
                if a not in taken:
                    break
            addresses[slot] = a
        return ("imm", addresses[slot])
    kind = spec["draw"]
    if kind == "word":
        return ("imm", rng.randrange(1 << word_bits))
    if kind == "shift":
        return ("imm", rng.randrange(1, word_bits))
    if kind == "divisor":
        return ("imm", rng.randrange(1, 1 << (word_bits // 2)))
    raise ValueError(f"unknown draw {kind!r}")


def program(config: dict, steps_log2: int, rng: random.Random) -> list:
    """One program of the configuration's class, sized to 2^steps_log2
    steps, its draws from `rng`."""
    spec, w = config["program"], config["word_bits"]
    addresses: dict = {}
    body = [(op, ri, rj, _operand(a, w, rng, addresses))
            for op, ri, rj, a in spec["body"]]
    iters = max(1, ((1 << steps_log2) - 2) // (len(body) + 3))
    return ([("Mov", 0, None, ("imm", iters))] + body
            + [("Sub", 0, 0, ("imm", 1)), ("Cmpe", 0, None, ("imm", 0)),
               ("CnJmp", None, None, ("imm", 1)),
               ("Answer", None, None, ("reg", spec["answer_reg"]))])


class Client:
    """The closed loop's one client: request i is program(i), each from its
    own stream of the seed, so that any request can be made again alone."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        self.config = config
        self.seed = seed
        sizes = traffic.get("steps_log2", [config["steps_log2"]])
        order = stream(seed, "sizes")
        self.sizes = [sizes[i] for i in order.sample(range(len(sizes)),
                                                     len(sizes))]

    def steps_log2(self, i: int) -> int:
        return self.sizes[i % len(self.sizes)]

    def program(self, i: int) -> list:
        return program(self.config, self.steps_log2(i),
                       stream(self.seed, f"program {i}"))

    def blinding_seed(self, i: int) -> int:
        """The seed of request i's blinding stream."""
        return stream(self.seed, f"blinding {i}").getrandbits(64)

    def warmup_programs(self) -> list:
        """The set-up's requests: one of each size the cell sends, drawn
        apart from the window's."""
        return [program(self.config, size, stream(self.seed, f"warm-up {size}"))
                for size in sorted(set(self.sizes))]

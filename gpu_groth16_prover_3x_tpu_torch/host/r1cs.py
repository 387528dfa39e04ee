"""R1CS constraint systems and the synthetic example generator.

Mirrors the reference's libsnark relations layer:
  - linear combinations / constraints / constraint system:
    libsnark/relations/constraint_satisfaction_problems/r1cs/r1cs.tcc and
    libsnark/relations/variable.tcc (index 0 is the constant one;
    variable i maps to assignment[i-1], variable.tcc:262-270)
  - swap_AB_if_beneficial: r1cs.tcc:194-243
  - generate_r1cs_example_with_field_input:
    relations/.../examples/r1cs_examples.tcc:25-97 (the alternating
    a*b=c / a+b=c chain the challenge's generate_parameters uses)
"""

import random
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


LinearCombination = List[Tuple[int, int]]  # [(var_index, coeff)], 0 == const 1


@dataclass
class Constraint:
    a: LinearCombination
    b: LinearCombination
    c: LinearCombination


@dataclass
class R1CS:
    primary_input_size: int
    auxiliary_input_size: int
    constraints: List[Constraint] = field(default_factory=list)
    p: int = 0  # scalar field modulus

    @property
    def num_variables(self) -> int:
        return self.primary_input_size + self.auxiliary_input_size

    @property
    def num_constraints(self) -> int:
        return len(self.constraints)

    @property
    def num_inputs(self) -> int:
        return self.primary_input_size

    def swap_ab_if_beneficial(self) -> bool:
        """r1cs.tcc:194-243: swap A<->B when B touches more variables."""
        touched_a = set()
        touched_b = set()
        for cons in self.constraints:
            touched_a.update(idx for idx, _ in cons.a)
            touched_b.update(idx for idx, _ in cons.b)
        if len(touched_b) > len(touched_a):
            for cons in self.constraints:
                cons.a, cons.b = cons.b, cons.a
            return True
        return False

    def is_satisfied(self, assignment: List[int]) -> bool:
        for cons in self.constraints:
            a = evaluate_lc(cons.a, assignment, self.p)
            b = evaluate_lc(cons.b, assignment, self.p)
            c = evaluate_lc(cons.c, assignment, self.p)
            if (a * b - c) % self.p:
                return False
        return True


def evaluate_lc(lc: LinearCombination, assignment: List[int], p: int) -> int:
    """variable.tcc:262-270 (index 0 = constant one)."""
    acc = 0
    for idx, coeff in lc:
        acc += (1 if idx == 0 else assignment[idx - 1]) * coeff
    return acc % p


def generate_r1cs_example_with_field_input(
    p: int, num_constraints: int, num_inputs: int, rng: random.Random
) -> Tuple[R1CS, List[int], List[int]]:
    """r1cs_examples.tcc:25-97.  Returns (cs, primary, auxiliary)."""
    assert num_inputs <= num_constraints + 2
    cs = R1CS(
        primary_input_size=num_inputs,
        auxiliary_input_size=2 + num_constraints - num_inputs,
        p=p,
    )
    assignment: List[int] = []
    a = rng.randrange(p)
    b = rng.randrange(p)
    assignment.append(a)
    assignment.append(b)

    for i in range(num_constraints - 1):
        if i % 2:
            # a * b = c
            A = [(i + 1, 1)]
            B = [(i + 2, 1)]
            C = [(i + 3, 1)]
            tmp = a * b % p
        else:
            # (a + b) * 1 = c
            A = [(i + 1, 1), (i + 2, 1)]
            B = [(0, 1)]
            C = [(i + 3, 1)]
            tmp = (a + b) % p
        assignment.append(tmp)
        a, b = b, tmp
        cs.constraints.append(Constraint(A, B, C))

    # final squaring constraint over all variables so far
    A: LinearCombination = []
    B: LinearCombination = []
    C: LinearCombination = []
    fin = 0
    for i in range(1, cs.num_variables):
        A.append((i, 1))
        B.append((i, 1))
        fin = (fin + assignment[i - 1]) % p
    C.append((cs.num_variables, 1))
    cs.constraints.append(Constraint(A, B, C))
    assignment.append(fin * fin % p)

    primary = assignment[:num_inputs]
    auxiliary = assignment[num_inputs:]
    assert cs.num_variables == len(assignment)
    assert cs.is_satisfied(assignment)
    return cs, primary, auxiliary

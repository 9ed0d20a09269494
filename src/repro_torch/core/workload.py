"""The paper's Table 2 workload as datalog programs.

One definition shared by the cross-backend benchmark suite
(``benchmarks/run.py``) and the backend-parity tests, so both exercise
the same programs. All pattern queries expect the edge relation loaded
as ``Edge`` with the aliases in :data:`ALIASES` pointing at it.
"""
from __future__ import annotations

from typing import List, Tuple

ALIASES = ("R", "S", "T", "U", "X", "Y", "R2", "S2", "T2")

TRIANGLE_COUNT = "C(;w:long) :- R(x,y),S(y,z),T(x,z); w=<<COUNT(*)>>."
TRIANGLE_LIST = "Tri(x,y,z) :- R(x,y),S(y,z),T(x,z)."
FOUR_CLIQUE = ("C(;w:long) :- R(x,y),S(y,z),T(x,z),U(x,a),X(y,a),Y(z,a); "
               "w=<<COUNT(*)>>.")
LOLLIPOP = "C(;w:long) :- R(x,y),S(y,z),T(x,z),U(x,a); w=<<COUNT(*)>>."
BARBELL = ("C(;w:long) :- R(x,y),S(y,z),T(x,z),U(x,a),R2(a,b),S2(b,c),"
           "T2(a,c); w=<<COUNT(*)>>.")


def pagerank_program(iters: int = 5) -> str:
    return (
        "N(;w:int) :- Edge(x,y); w=<<COUNT(x)>>.\n"
        "InvDeg(x;y:float) :- Edge(x,z); y=1.0/<<COUNT(z)>>.\n"
        "PageRank(x;y:float) :- Edge(x,z); y=1.0/N.\n"
        f"PageRank(x;y:float)*[i={iters}] :- Edge(x,z),PageRank(z),"
        "InvDeg(z); y=0.15/N+0.85*<<SUM(z)>>.")


def sssp_program(source) -> str:
    return (f"SSSP(x;y:int) :- Edge({source},x); y=1.\n"
            "SSSP(x;y:int)* :- Edge(w,x),SSSP(w); y=<<MIN(w)>>+1.")


def paper_query_set(source=0, pr_iters: int = 5) -> List[Tuple[str, str]]:
    """(name, program) pairs for the full Table 2 workload."""
    return [
        ("triangle", TRIANGLE_COUNT),
        ("4clique", FOUR_CLIQUE),
        ("lollipop", LOLLIPOP),
        ("barbell", BARBELL),
        ("pagerank", pagerank_program(pr_iters)),
        ("sssp", sssp_program(source)),
    ]

"""The matrix-free element operator apply of the FEM, for E tetrahedra of
`nodes` nodes each (4 at order 1, 10 at order 2) on V vertices:

    K X = sum_e P_e^T (mu_c K_mu,e + lam_c K_lam,e) P_e X     (c columns)
    M X = sum_e P_e^T (|det A_e| Mref (x) I_3) P_e X

Operations: one product of the material-combined (3N, 3N) element block
with the element's (3N, c) slab, a multiply-add per entry and column (the
combination of the two material blocks is left out: it is c-independent
work a kernel may do once per pair).  M: the (N, N) reference block with
each element's (N, 3c) slab.  Bytes: the element blocks, the element
node list (int64) and X read once, the result written once (float32).
"""


def count(E: int, nodes: int, cols: int, V: int) -> tuple:
    """(flops, bytes) of K X."""
    n3 = 3 * nodes
    return 2 * E * n3 * n3 * cols, 4 * (2 * E * n3 * n3 + 2 * 3 * V * cols) + 8 * E * nodes


def mass_count(E: int, nodes: int, cols: int, V: int) -> tuple:
    """(flops, bytes) of M X."""
    return 2 * E * nodes * nodes * 3 * cols, 4 * (E + nodes * nodes + 2 * 3 * V * cols) + 8 * E * nodes

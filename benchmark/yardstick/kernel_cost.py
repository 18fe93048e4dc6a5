"""Operations and bytes of one launch of each GP kernel, from its shape.

Each input byte is counted read once and each output byte written once, as
float32. The counts are what the algorithm needs, not what an
implementation executes.
"""


def factor_prep(n: int, r: int, l: int) -> tuple[float, float]:
    """(FLOP, bytes) of G = UᵀU (its symmetric half), UᵀZ and ‖Z‖² over U
    (N, R) and Z (N, L)."""
    flop = n * r * (r + 1) + 2.0 * n * r * l
    nbytes = 4.0 * (n * (r + l) + r * (r + l) + 1)
    return flop, nbytes


def nll_core(r: int, l: int) -> tuple[float, float]:
    """(FLOP, bytes) of the NLL core's forward: the Cholesky of
    B = I + G/v_n (R³/3), X = L_B⁻¹ (R³/3) and W = X·UᵀZ (R²L); it reads
    G's lower half, UᵀZ, ‖Z‖² and v_n and writes the NLL, X and W."""
    flop = 2.0 * r**3 / 3.0 + float(r * r * l)
    nbytes = 4.0 * (r * (r + 1) / 2 + r * l + 2 + 1 + r * r + r * l)
    return flop, nbytes

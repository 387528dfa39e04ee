"""The benchmark's plain reference of the Groth16 prover.

Plain Python, NumPy and PyTorch only: nothing here imports the program
under test (`gpu_groth16_prover_3x_tpu_torch`), the JAX package or JAX.
`keys` makes the proving keys and the inputs from a seed, `algebra` holds
the exact field and group arithmetic, `limbs` the plain vector field
arithmetic, and `proof` works out from the keys' known discrete logs the
proof that the prover has to return, byte for byte.
"""

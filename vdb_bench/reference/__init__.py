"""The plain reference the benchmark holds the program to.

Plain PyTorch only: nothing here imports the program
(``vector_database_tpu_torch``) or JAX, and nothing here takes a tensor
the program made. It works from the rows and queries the benchmark drew
itself (``vdb_bench.recipe``), and reads the program's answers only to
judge them.
"""

"""The plain reference: each job's answer worked out again in float64.

Plain torch (float64, TF32 off) on the genotypes that
:mod:`genobench.genotypes` makes from the seed; nothing here imports the
port or takes anything the port made.  ``rnd`` arguments, where a function
has them, round every vector operand of a genotype product to that type
first: the control (bfloat16), which the comparison has to fail.
"""

"""The benchmark's plain reference: a frozen copy, in plain PyTorch and
NumPy, of the port's SoC layer as it stood when the benchmark was added.

It holds the fused episode step and the serving step (:mod:`.step`),
threefry (:mod:`.prng`), the application generator and compiler
(:mod:`.apps`, :func:`.episodes.compile_app`), the manual policy's
lowering (:func:`.episodes.precompute_manual_modes`), the timing model,
the Q-learning rules, the traffic generator and the reward.  It imports
nothing of the program: the program may change, this copy does not, and
the benchmark's ``correct`` holds the program to it.
"""

"""Force engines and compute kernels (the GPU analog of src/all_pairs.h).

allpairs.py is plain torch; cuda_allpairs.py wraps the hand-written CUDA
kernels of csrc/allpairs.cu and keeps their plain twins beside them.
"""

"""Force engines and compute kernels (the GPU analog of src/all_pairs.h).

allpairs.py is plain torch; cuda_allpairs.py wraps the hand-written CUDA
kernels of csrc/allpairs.cu and keeps their plain twins beside them, as
cuda_group_eval.py does for the trees' kernels in csrc/group_eval.cu, and
cuda_allpairs_mxu.py for the hybrid kernel of csrc/allpairs_mxu.cu.
octree*.py, hilbert.py and bvh*.py are the trees around them.
"""

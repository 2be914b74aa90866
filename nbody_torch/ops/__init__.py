"""Force engines and compute kernels (the GPU analog of src/all_pairs.h).

allpairs.py is plain torch; cuda_allpairs.py wraps the hand-written CUDA
kernels of csrc/allpairs.cu and keeps their plain twins beside them, as
cuda_group_eval.py does for the octree's kernels in csrc/group_eval.cu.
octree.py and octree_group.py are the octree's fast path around them.
"""

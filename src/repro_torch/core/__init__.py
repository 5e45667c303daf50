"""Shape-dispatched tall-and-skinny GEMM."""

"""knn_cells (cells; layer dither and reconstruct): the cells an encode
sends through a top-k kernel, the program's counter
step_stats["knn_kernel_cells"] of the window's first encode."""


def read(run):
    enc = run.encodes
    return enc[0].step_stats.get("knn_kernel_cells") if enc else None

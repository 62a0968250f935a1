"""rank_exact.device_ms (ms): device ms a pass of the exact rank transforms
(``ops/ranknorm.py``, ``ops/seghist.py``): K13's histogram and digit
passes, K12's tied-rank passes and Blom table, K10's valley merge, K11's
segment moments, and the transposes' copies (PyTorch's direct copy kernel,
which the exact path runs only there). By kernel name."""

from portbench.readers import device_ms_per_pass

KERNELS = (
    "radix_histogram", "radix_digit_pass",                 # K13
    "tied_ranks_kernel", "place_kernel", "blom_table_kernel",  # K12
    "valley_split_kernel", "valley_partition_kernel", "valley_merge_kernel",  # K10
    "seg_init_kernel", "seg_accumulate_kernel", "seg_finish_kernel",  # K11
    "direct_copy_kernel",                                  # the transposes
)


def read(ctx):
    return device_ms_per_pass(ctx, KERNELS)

"""One file a kernel: KERNEL_NAME (the name its device records carry),
WRAP (module, attribute) of the function that launches it as the program
calls it, work_from_shapes(...) -> (bytes, operations), and work(args,
kwargs) -> a callable giving the same for one call once the profiled
stretch has ended."""

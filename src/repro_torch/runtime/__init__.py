"""Runtime helpers of the port (counterpart of ``repro.runtime``): the
fault-tolerance primitives the resident study service leans on."""

"""Static checks of the port: the kernel-launch contracts
(``analysis.contracts``), the dataflow verifier of the CUDA launches
(``analysis.kernel_verify``), the contract audit (``analysis.audit``) and
the linter of the port's boundaries (``analysis.lint``)."""

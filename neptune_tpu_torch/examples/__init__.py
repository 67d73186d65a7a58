"""The repository's example programs, written with the port.

One module for each program of the repository's `examples/`, under the
same name, the same program line for line in PyTorch idiom (tensors on an
explicit device, slice assignment on copies, seeded generators). Each runs
as

    python -m neptune_tpu_torch.examples.<name> [--cpu] [--procs N]

on the card by default (raising without one), on the CPU in f64 with
--cpu; the mesh examples take --procs N (`_cli`). Each exposes its
program's functions and a `main()` that returns the numbers it prints.

  allen_cahn              IMEX, Newton–Krylov and RK4 steps of Allen–Cahn
  black_scholes           backward induction by Newton, index-dependent coefficients
  ca_krylov_poisson       CA-CG, CA-GMRES, CA-BiCGStab beside per-iteration CG
  comm_avoiding_jacobi    K sweeps per exchange, then CA-Chebyshev
  gray_scott              two coupled fields on a torus through `simulate`
  heat3d_explicit         64^3 explicit heat against the discrete eigenmode
  heat_implicit           `@jit_class` CG steps and the traced IR
  inverse_problem         gradient descent through `differentiable_solve`
  multichip_poisson       CG over a sharded opdef, the explicit matvec
  multigrid_poisson       V-cycles, plain CG and MG-preconditioned CG
  navier_stokes           a lid-driven cavity run by `SimulationDriver`
  preconditioned_poisson  CG with no, Jacobi, SSOR and multigrid preconditioning
  swe_implicit            a shallow-water dam break by Newton–Krylov
  wave_leapfrog           256^2 leapfrog wave against the standing mode

The modules define their opdefs when they are imported, as the JAX
examples do, in the global DSL context: run one in a fresh context
(`runpy.run_module`) after `ntt.reset_context()`.
"""

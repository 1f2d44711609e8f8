"""``python -m classmate_rag_tpu_torch.cli <command> ...``"""

from classmate_rag_tpu_torch.cli.main import main

if __name__ == "__main__":
    raise SystemExit(main())

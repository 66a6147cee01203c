from tpu_resnet_torch.main import main

if __name__ == "__main__":
    raise SystemExit(main())

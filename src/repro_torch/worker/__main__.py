from repro_torch.service.worker import main

if __name__ == "__main__":
    main()
